"""The modality frontends' stubs and the VLM projector — the counterpart
of ``repro.models.multimodal``.

VLM (pixtral): the batch carries precomputed ViT patch embeddings
``patch_embeds (B, n_patches, d_model)``; the decoder projects them with a
learned ``d_model x d_model`` matrix (``projector.w``) and prepends them
to the text-token embeddings.  Audio (seamless): the batch carries
precomputed mel+conv frame embeddings ``frames (B, n_frames, d_model)``,
which feed the encoder as they are.
"""
from __future__ import annotations

import torch

from .layers import truncated_normal_init


def projector_param_shapes(d_in: int, d_model: int) -> dict[str, tuple[int, ...]]:
    """The projector's one leaf, by its path under ``projector``."""
    return {"w": (d_in, d_model)}


def projector_init(d_in: int, d_model: int, dtype, generator: torch.Generator, *,
                   device) -> dict[str, torch.Tensor]:
    """``{"w": (d_in, d_model)}``, truncated normal at ``1 / sqrt(d_in)``
    (the reference's rule, from a ``torch.Generator``)."""
    return {"w": truncated_normal_init(projector_param_shapes(d_in, d_model)["w"],
                                       dtype, generator, device=device)}


def project(params, embeds: torch.Tensor, compute_dtype) -> torch.Tensor:
    """(B, P, d_in) -> (B, P, d_model) in ``compute_dtype``."""
    return embeds.to(compute_dtype) @ params["w"].to(compute_dtype)


def frontend_embed_specs(cfg, batch: int) -> torch.Tensor:
    """The stub frontend's output for ``batch`` rows as a ``meta`` tensor:
    ``(batch, frontend_tokens, d_model)`` in the compute dtype."""
    return torch.empty((batch, cfg.frontend_tokens, cfg.d_model),
                       dtype=getattr(torch, cfg.compute_dtype), device="meta")


def synth_frontend_embeds(generator: torch.Generator, cfg, batch: int, *,
                          device) -> torch.Tensor:
    """Synthetic frontend embeddings: standard normals in the compute dtype
    times 0.02, ``(batch, frontend_tokens, d_model)``.  They are drawn from
    ``generator``, so the values differ from the reference's
    ``jax.random`` draws; the shape, dtype and scale are the same."""
    shape = (batch, cfg.frontend_tokens, cfg.d_model)
    x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return x.to(getattr(torch, cfg.compute_dtype)) * 0.02


__all__ = [
    "frontend_embed_specs",
    "project",
    "projector_init",
    "projector_param_shapes",
    "synth_frontend_embeds",
]
