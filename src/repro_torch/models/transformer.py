"""Decoder stack of the dense family: per-layer parameters stacked over a
leading ``(num_layers,)`` axis and consumed by a loop over the layer index
(the reference scans over the same stacked leaves).  ``cfg.remat`` wraps
each layer in ``torch.utils.checkpoint``, which changes memory, not values.
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


def _layer(tree, i: int):
    """Row ``i`` of every stacked leaf of a nested parameter container."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _layer(v, i) for k, v in tree.items()}


def _attn_block_train(p, x, cfg):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn.attn_train(p["attn"], h, cfg)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.mlp_act, getattr(torch, cfg.compute_dtype))


def stack_train(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    blocks = params["blocks"]["b0"]
    for i in range(cfg.num_layers):
        if cfg.remat:
            x = checkpoint(
                lambda x_, i_=i: _attn_block_train(_layer(blocks, i_), x_, cfg),
                x, use_reentrant=False,
            )
        else:
            x = _attn_block_train(_layer(blocks, i), x, cfg)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)
