"""Decoder stack of the dense and MoE families: a loop over superblocks,
on the training path (``stack_train``) and the decode path
(``stack_decode`` over the stacked caches of ``init_caches``).

A *superblock* is the repeating unit of the architecture: one block for
plain dense and MoE, a (local, global) pair for gemma2.  Each block's
parameters are stacked over a leading ``(num_superblocks,)`` axis under
``blocks.b{j}`` and consumed by a loop over the superblock index (the
reference scans over the same stacked leaves).  ``cfg.remat`` wraps each
superblock in ``torch.utils.checkpoint``, which changes memory, not
values.

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
from . import moe as moe_mod
from .layers import mlp, rmsnorm

def superblock_kinds(cfg) -> list[tuple[str, int]]:
    """``[(kind, window)]`` for each block of one superblock."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    if cfg.local_global:
        return [("attn", cfg.sliding_window or 4096), ("attn", 0)]
    return [("attn", cfg.sliding_window)]


def num_superblocks(cfg) -> int:
    """The stacked leaves' row count: the loop's stages before the final
    norm and head."""
    kinds = superblock_kinds(cfg)
    n, r = divmod(cfg.num_layers, len(kinds))
    if r:
        raise ValueError(
            f"{cfg.name}: num_layers={cfg.num_layers} not divisible by "
            f"superblock size {len(kinds)}")
    return n


def _block_param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """One attention block's leaf shapes (one row), by path under it."""
    d, f = cfg.d_model, cfg.d_ff
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {
        "attn.wq": (d, H * hd),
        "attn.wk": (d, K * hd),
        "attn.wv": (d, K * hd),
        "attn.wo": (H * hd, d),
        "ln1.scale": (d,),
        "ln2.scale": (d,),
    }
    if cfg.qkv_bias:
        shapes.update({"attn.bq": (H * hd,), "attn.bk": (K * hd,),
                       "attn.bv": (K * hd,)})
    if cfg.is_moe:
        shapes.update({f"moe.{k}": s for k, s in moe_mod.moe_param_shapes(cfg).items()})
    else:
        shapes.update({"mlp.w_gate": (d, f), "mlp.w_up": (d, f), "mlp.w_down": (f, d)})
    return shapes


def stack_param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Shapes of the stack's leaves, keyed by their path under ``stack``."""
    n = num_superblocks(cfg)
    shapes = {
        f"blocks.b{j}.{k}": (n,) + s
        for j in range(len(superblock_kinds(cfg)))
        for k, s in _block_param_shapes(cfg).items()
    }
    shapes["final_norm.scale"] = (cfg.d_model,)
    return shapes


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


def _attn_block_train(p, x, cfg, window):
    """-> ``(x, aux)``; ``aux`` is ``None`` for a dense block."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn.attn_train(p["attn"], h, cfg, window=window)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.is_moe:
        y, aux = moe_mod.moe_apply(p["moe"], h, cfg)
        return x + y, aux
    return x + mlp(p["mlp"], h, cfg.mlp_act, getattr(torch, cfg.compute_dtype)), None


def _superblock_train(p, x, aux, cfg, kinds):
    for j, (_, window) in enumerate(kinds):
        x, a = _attn_block_train(p[f"b{j}"], x, cfg, window)
        if a is not None:
            aux = aux + a
    return x, aux


def stack_train(params, x: torch.Tensor, cfg, before_layer=None):
    """x: (B, S, d) -> ``(y, aux_loss)``, the sum of the blocks' aux losses
    (0 for dense).  ``before_layer(i)``, when given, is called before
    superblock ``i`` reads its rows, and once more with ``i =
    num_superblocks`` before the final norm.  It and the read of the rows
    run outside the checkpointed superblock, so the backward pass's
    recompute repeats neither."""
    kinds = superblock_kinds(cfg)
    n = num_superblocks(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        if before_layer is not None:
            before_layer(i)
        p = _layer(params["blocks"], i)
        if cfg.remat:
            x, aux = checkpoint(
                lambda x_, a_, p_=p: _superblock_train(p_, x_, a_, cfg, kinds),
                x, aux, use_reentrant=False,
            )
        else:
            x, aux = _superblock_train(p, x, aux, cfg, kinds)
    if before_layer is not None:
        before_layer(n)
    final_norm = {k: resolve(v) for k, v in params["final_norm"].items()}
    return rmsnorm(final_norm, x, cfg.norm_eps), aux


# ---------------------------------------------------------------------------
# decode (one token, stacked caches read row by row beside the params)
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, max_len: int, *, device) -> dict:
    """The caches stacked over superblocks, ``{"blocks": {"b{j}": {"k":
    (n, B, T, K, hd), ...}}}`` as in the reference (the batch axis is 1);
    zeros, or shapes only on the ``meta`` device."""
    n = num_superblocks(cfg)
    caches = {}
    for j, (_, window) in enumerate(superblock_kinds(cfg)):
        one = attn.init_cache(cfg, batch, max_len, window=window, device="meta")
        caches[f"b{j}"] = {k: torch.zeros((n,) + tuple(v.shape), dtype=v.dtype,
                                          device=device)
                           for k, v in one.items()}
    return {"blocks": caches}


def _block_decode(p, x, cache, pos, cfg, kind, window):
    if kind != "attn":  # mamba, mlstm, slstm: their families wait for a later slice
        raise NotImplementedError(
            f"block kind {kind!r} of family {cfg.family!r} is not ported")
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, cache = attn.attn_decode(p["attn"], h, cache, pos, cfg, window=window)
    x = x + y
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.is_moe:
        # every slot routes, active or not, as in the reference: the
        # capacity depends on the decode batch
        y, _ = moe_mod.moe_apply(p["moe"], h, cfg)
    else:
        y = mlp(p["mlp"], h, cfg.mlp_act, getattr(torch, cfg.compute_dtype))
    return x + y, cache


def stack_decode(params, x: torch.Tensor, caches: dict, pos: torch.Tensor, cfg):
    """x: (B, 1, d); pos: (B,).  Each superblock reads its parameter rows
    and writes its cache rows (views of the stacked caches) in place.
    Returns ``(y, caches)``."""
    kinds = superblock_kinds(cfg)
    for i in range(num_superblocks(cfg)):
        p = _layer(params["blocks"], i)
        for j, (kind, window) in enumerate(kinds):
            rows = {k: v[i] for k, v in caches["blocks"][f"b{j}"].items()}
            x, _ = _block_decode(p[f"b{j}"], x, rows, pos, cfg, kind, window)
    final_norm = {k: resolve(v) for k, v in params["final_norm"].items()}
    return rmsnorm(final_norm, x, cfg.norm_eps), caches
