"""The dense decoder as an ``nn.Module`` and its chunked softmax-xent loss —
the counterpart of the decoder half of ``repro.models.model``.

Parameters keep the reference's paths and stacked shapes (``embed.table``,
``head.w``, ``stack.blocks.b0.attn.wq`` of shape ``(L, d, H*hd)``, ...).
:func:`leaves` lists them in the reference's leaf order, which is
``jax.tree_util.tree_leaves`` of the nested dict: keys sorted at every
level.  The bucket plan, the optimizer and the EF residuals all follow that
order.  As in the reference, the output head is untied and the vocab is
padded to a multiple of 128.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import transformer
from .layers import embed, normal_init, truncated_normal_init


def padded_vocab(cfg: ArchConfig) -> int:
    return int(math.ceil(cfg.vocab_size / 128) * 128)


def param_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's shape by dotted path, in leaf order."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    V = padded_vocab(cfg)
    shapes = {"embed.table": (V, cfg.d_model), "head.w": (cfg.d_model, V)}
    for k, s in transformer.stack_param_shapes(cfg).items():
        shapes[f"stack.{k}"] = s
    return dict(sorted(shapes.items(), key=lambda kv: kv[0].split(".")))


def _nest(flat: dict[str, nn.Parameter]) -> nn.Module:
    """Nested ``ModuleDict``/``ParameterDict`` containers for dotted paths."""
    groups: dict[str, dict[str, nn.Parameter]] = {}
    leaves: dict[str, nn.Parameter] = {}
    for path, p in flat.items():
        head, _, rest = path.partition(".")
        if rest:
            groups.setdefault(head, {})[rest] = p
        else:
            leaves[head] = p
    if leaves and groups:
        raise ValueError(f"mixed leaves and groups: {sorted(flat)}")
    if leaves:
        return nn.ParameterDict(leaves)
    return nn.ModuleDict({k: _nest(v) for k, v in groups.items()})


def _xent_chunked(head_w, x, labels, cfg):
    """x: (B,S,d) hidden; labels: (B,S), -1 = ignore.  Softmax-xent in
    sequence chunks of ``cfg.xent_chunk`` so the (B,c,V) logits buffer is
    bounded; returns the mean over unmasked labels."""
    B, S, d = x.shape
    c = min(cfg.xent_chunk, S)
    if S % c != 0:
        c = S
    cd = getattr(torch, cfg.compute_dtype)
    w = head_w.to(cd)
    loss_sum = x.new_zeros((), dtype=torch.float32)
    count = x.new_zeros((), dtype=torch.float32)
    for off in range(0, S, c):
        xk, lk = x[:, off:off + c], labels[:, off:off + c]
        logits = (xk.to(cd) @ w).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lk.clamp(min=0)[..., None])[..., 0]
        mask = (lk >= 0).float()
        loss_sum = loss_sum + torch.sum((lse - ll) * mask)
        count = count + torch.sum(mask)
    return loss_sum / torch.clamp(count, min=1.0)


class DecoderLM(nn.Module):
    """Dense decoder-only LM: embedding (scaled by ``sqrt(d_model)``), the
    stacked layer loop, final RMSNorm, untied head, chunked xent."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
        dtype = getattr(torch, cfg.param_dtype)
        flat = {
            path: nn.Parameter(torch.empty(shape, dtype=dtype, device=dev))
            for path, shape in param_shapes(cfg).items()
        }
        for name, sub in _nest(flat).items():
            self.add_module(name, sub)
        self.init_params(seed)

    def named_leaves(self) -> list[tuple[str, nn.Parameter]]:
        """``(path, parameter)`` in the reference's leaf order."""
        return sorted(self.named_parameters(), key=lambda kv: kv[0].split("."))

    @torch.no_grad()
    def init_params(self, seed: int) -> None:
        """Reference init rules (N(0, 0.02) embedding, truncated normal
        matrices, zero norm scales), drawn from a seeded ``torch.Generator``
        on the parameters' device."""
        dev = self.embed["table"].device
        gen = None if dev.type == "meta" else torch.Generator(dev).manual_seed(seed)
        for path, p in self.named_leaves():
            if path == "embed.table":
                v = normal_init(p.shape, p.dtype, gen, device=dev, std=0.02)
            elif path.endswith(".scale"):
                v = torch.zeros(p.shape, dtype=p.dtype, device=dev)
            else:
                v = truncated_normal_init(p.shape, p.dtype, gen, device=dev)
            p.copy_(v)

    def loss_fn(self, batch: dict[str, torch.Tensor], before_layer=None):
        """-> (total_loss, {"loss", "aux_loss"}), as the reference's
        ``loss_fn`` returns them (the dense family has no aux loss).
        ``before_layer`` goes to :func:`transformer.stack_train`: it is
        called before each layer and before the final norm and head."""
        cfg = self.cfg
        cd = getattr(torch, cfg.compute_dtype)
        x = embed(self.embed["table"], batch["tokens"], cd)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cd, device=x.device)
        x = transformer.stack_train(self.stack, x, cfg, before_layer)
        loss = _xent_chunked(self.head["w"], x, batch["labels"], cfg)
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss + aux, {"loss": loss, "aux_loss": aux}


def build_model(cfg: ArchConfig, *, device="cuda", seed: int = 0) -> DecoderLM:
    return DecoderLM(cfg, device=device, seed=seed)
