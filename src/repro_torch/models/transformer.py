"""Decoder stack of the dense family: per-layer parameters stacked over a
leading ``(num_layers,)`` axis and consumed by a loop over the layer index
(the reference scans over the same stacked leaves).  ``cfg.remat`` wraps
each layer in ``torch.utils.checkpoint``, which changes memory, not values.

The parameters come as a nested container whose leaves are tensors, as the
module holds them, or as a replacement tree (``core.overlap.install_hooks``):
a stacked leaf may be a sequence of per-row tensors, and any leaf or row may
be *deferred*, a zero-argument callable that assembles it when it is first
read (:func:`resolve`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .layers import mlp, rmsnorm


def stack_param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Shapes of the stack's leaves, keyed by their path under ``stack``."""
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "blocks.b0.attn.wq": (L, d, H * hd),
        "blocks.b0.attn.wk": (L, d, K * hd),
        "blocks.b0.attn.wv": (L, d, K * hd),
        "blocks.b0.attn.wo": (L, H * hd, d),
        "blocks.b0.ln1.scale": (L, d),
        "blocks.b0.ln2.scale": (L, d),
        "blocks.b0.mlp.w_gate": (L, d, f),
        "blocks.b0.mlp.w_up": (L, d, f),
        "blocks.b0.mlp.w_down": (L, f, d),
        "final_norm.scale": (d,),
    }


def resolve(x, dtype=None):
    """A parameter as a tensor: a deferred one is assembled now.  With a
    ``dtype``, a deferred parameter is assembled from pieces cast to it
    (the same values as casting the whole); a tensor is returned as it is,
    for the caller to cast."""
    if callable(x):
        return x(dtype)
    return x


def _layer(tree, i: int):
    """Row ``i`` of every stacked leaf of a nested parameter container: of
    a stacked tensor or of a sequence of per-row tensors."""
    if hasattr(tree, "items"):
        return {k: _layer(v, i) for k, v in tree.items()}
    return resolve(tree[i])


def _attn_block_train(p, x, cfg):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn.attn_train(p["attn"], h, cfg)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.mlp_act, getattr(torch, cfg.compute_dtype))


def stack_train(params, x: torch.Tensor, cfg, before_layer=None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  ``before_layer(i)``, when given, is
    called before layer ``i`` reads its rows, and once more with ``i =
    num_layers`` before the final norm.  It and the read of the layer's
    rows run outside the checkpointed layer, so the backward pass's
    recompute repeats neither."""
    blocks = params["blocks"]["b0"]
    for i in range(cfg.num_layers):
        if before_layer is not None:
            before_layer(i)
        p = _layer(blocks, i)
        if cfg.remat:
            x = checkpoint(
                lambda x_, p_=p: _attn_block_train(p_, x_, cfg),
                x, use_reentrant=False,
            )
        else:
            x = _attn_block_train(p, x, cfg)
    if before_layer is not None:
        before_layer(cfg.num_layers)
    final_norm = {k: resolve(v) for k, v in params["final_norm"].items()}
    return rmsnorm(final_norm, x, cfg.norm_eps)
