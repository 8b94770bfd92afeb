"""Decoder stack: a loop over superblocks, on the training path
(``stack_train``) and the decode path (``stack_decode`` over the stacked
caches of ``init_caches``).

A *superblock* is the repeating unit of the architecture: one attention
block for plain dense, VLM and MoE, a (local, global) pair for gemma2,
``slstm_every - 1`` mLSTM blocks and one sLSTM block for xlstm,
``attn_every`` Mamba2 blocks for zamba2, whose one weight-shared
attention block (``stack.shared``) runs after every superblock.  Each
block's parameters are stacked over a leading ``(num_superblocks,)`` axis
under ``blocks.b{j}`` and consumed by a loop over the superblock index
(the reference scans over the same stacked leaves).  An MoE stack with
``first_k_dense_replace = k`` runs ``k`` dense attention blocks first
(``stack.dense``, stacked over ``k``, MLP width ``intermediate_size``):
they are the loop's first ``k`` stages, and the superblocks follow.
``cfg.remat`` wraps each superblock and each dense block in
``torch.utils.checkpoint``, which changes memory, not values.

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
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .layers import mlp, rmsnorm

def superblock_kinds(cfg) -> list[tuple[str, int]]:
    """``[(kind, window)]`` for each block of one superblock."""
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        if cfg.local_global:
            return [("attn", cfg.sliding_window or 4096), ("attn", 0)]
        return [("attn", cfg.sliding_window)]
    if fam == "ssm":  # xlstm: k - 1 mLSTM blocks and one sLSTM block
        if cfg.slstm_every and cfg.slstm_every > 1:
            return [("mlstm", 0)] * (cfg.slstm_every - 1) + [("slstm", 0)]
        return [("mlstm", 0)]
    if fam == "hybrid":  # zamba2: k mamba blocks, then the shared block
        return [("mamba", 0)] * (cfg.attn_every or 6)
    raise NotImplementedError(f"family {fam!r} is not ported")


def dense_prefix(cfg) -> int:
    """The leading dense layers of an MoE stack (``stack.dense``'s rows)."""
    return cfg.first_k_dense_replace if cfg.is_moe else 0


def num_stages(cfg) -> int:
    """The layer loop's stages before the final norm and head: the dense
    prefix's rows, then the superblocks."""
    return dense_prefix(cfg) + num_superblocks(cfg)


def num_superblocks(cfg) -> int:
    """The stacked ``blocks`` leaves' row count: the layers after the dense
    prefix over the superblock's size."""
    kinds = superblock_kinds(cfg)
    n, r = divmod(cfg.num_layers - dense_prefix(cfg), len(kinds))
    if r:
        raise ValueError(
            f"{cfg.name}: num_layers={cfg.num_layers} not divisible by "
            f"superblock size {len(kinds)}")
    return n


def has_shared_block(cfg) -> bool:
    """zamba2's weight-shared attention block, applied after every
    superblock."""
    return cfg.family == "hybrid" and (cfg.attn_every or 0) > 0


def _shared_sub_cfg(cfg):
    """The shared block's config: dense, with ``d_ff`` (``4 d_model`` when
    the config has none)."""
    d_ff = cfg.d_ff if cfg.d_ff > 0 else 4 * cfg.d_model
    return cfg.with_(num_experts=0, d_ff=d_ff)


def _dense_sub_cfg(cfg):
    """A leading dense block's config: its attention, an MLP of width
    ``intermediate_size``."""
    return cfg.with_(num_experts=0, d_ff=cfg.intermediate_size)


def _attn_param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """One attention block's leaf shapes (one row), by path under it."""
    d, f = cfg.d_model, cfg.d_ff
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.is_mla:
        shapes = {f"attn.{k}": s for k, s in attn.mla_param_shapes(cfg).items()}
    else:
        shapes = {"attn.wq": (d, H * hd), "attn.wk": (d, K * hd),
                  "attn.wv": (d, K * hd), "attn.wo": (H * hd, d)}
    shapes.update({"ln1.scale": (d,), "ln2.scale": (d,)})
    if cfg.qkv_bias:
        shapes.update({"attn.bq": (H * hd,), "attn.bk": (K * hd,),
                       "attn.bv": (K * hd,)})
    if cfg.is_moe:
        shapes.update({f"moe.{k}": s for k, s in moe_mod.moe_param_shapes(cfg).items()})
    else:
        shapes.update({"mlp.w_gate": (d, f), "mlp.w_up": (d, f), "mlp.w_down": (f, d)})
    return shapes


def _block_param_shapes(cfg, kind: str) -> dict[str, tuple[int, ...]]:
    """One block's leaf shapes (one row), by path under it."""
    if kind == "attn":
        return _attn_param_shapes(cfg)
    if kind == "mamba":
        shapes = {f"ssm.{k}": s for k, s in ssm_mod.ssm_param_shapes(cfg).items()}
        shapes["ln.scale"] = (cfg.d_model,)
        return shapes
    if kind == "mlstm":
        return xlstm_mod.mlstm_param_shapes(cfg)
    if kind == "slstm":
        return xlstm_mod.slstm_param_shapes(cfg)
    raise ValueError(kind)


def stack_param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Shapes of the stack's leaves, keyed by their path under ``stack``."""
    n = num_superblocks(cfg)
    shapes = {
        f"blocks.b{j}.{k}": (n,) + s
        for j, (kind, _) in enumerate(superblock_kinds(cfg))
        for k, s in _block_param_shapes(cfg, kind).items()
    }
    shapes["final_norm.scale"] = (cfg.d_model,)
    k = dense_prefix(cfg)
    if k:
        shapes.update({f"dense.{p}": (k,) + s
                       for p, s in _attn_param_shapes(_dense_sub_cfg(cfg)).items()})
    if has_shared_block(cfg):
        shapes.update({f"shared.{k}": s
                       for k, s in _attn_param_shapes(_shared_sub_cfg(cfg)).items()})
    return shapes


def leaf_kind(cfg, path: str) -> str | None:
    """The block kind a stack leaf belongs to (``"attn"``, ``"mamba"``,
    ``"mlstm"``, ``"slstm"``; the shared and dense blocks are ``"attn"``),
    from its path under ``stack``; ``None`` for any other leaf."""
    parts = path.split(".")
    if parts[:1] in (["shared"], ["dense"]):
        return "attn"
    if parts[:1] == ["blocks"]:
        return superblock_kinds(cfg)[int(parts[1][1:])][0]
    return None


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


def _resolved(tree):
    """Every leaf of a nested (unstacked) container as a tensor."""
    if hasattr(tree, "items"):
        return {k: _resolved(v) for k, v in tree.items()}
    return resolve(tree)


def _attn_block_train(p, x, cfg, window):
    """-> ``(x, aux)``; ``aux`` is ``None`` for a dense block."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn.attn_train(p["attn"], h, cfg, window=window)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.is_moe:
        y, aux = moe_mod.moe_apply(p["moe"], h, cfg)
        return x + y, aux
    return x + mlp(p["mlp"], h, cfg.mlp_act, getattr(torch, cfg.compute_dtype)), None


def _block_train(p, x, cfg, kind, window):
    if kind == "attn":
        return _attn_block_train(p, x, cfg, window)
    if kind == "mamba":
        h = rmsnorm(p["ln"], x, cfg.norm_eps)
        return x + ssm_mod.ssm_train(p["ssm"], h, cfg), None
    if kind == "mlstm":
        return x + xlstm_mod.mlstm_train(p, x, cfg), None
    if kind == "slstm":
        return x + xlstm_mod.slstm_train(p, x, cfg), None
    raise ValueError(kind)


def _superblock_train(p, x, aux, cfg, kinds, shared=None):
    for j, (kind, window) in enumerate(kinds):
        x, a = _block_train(p[f"b{j}"], x, cfg, kind, window)
        if a is not None:
            aux = aux + a
    if shared is not None:
        x, _ = _attn_block_train(shared, x, _shared_sub_cfg(cfg), 0)
    return x, aux


def _dense_block_train(p, x, cfg):
    return _attn_block_train(p, x, _dense_sub_cfg(cfg), 0)[0]


def stack_train(params, x: torch.Tensor, cfg, before_layer=None):
    """x: (B, S, d) -> ``(y, aux_loss)``, the sum of the blocks' aux losses
    (0 for dense).  ``before_layer(i)``, when given, is called before stage
    ``i`` reads its rows (dense row ``i`` for ``i`` under the dense prefix
    ``k``, then superblock ``i - k``), and once more with ``i =``
    :func:`num_stages` before the final norm.  It and the read of the rows
    run outside the checkpointed block, so the backward pass's recompute
    repeats neither.  The shared block's leaves are read once, after
    ``before_layer(0)``: every application uses the same tensors."""
    kinds = superblock_kinds(cfg)
    n = num_superblocks(cfg)
    k = dense_prefix(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(k):
        if before_layer is not None:
            before_layer(i)
        p = _layer(params["dense"], i)
        if cfg.remat:
            x = checkpoint(lambda x_, p_=p: _dense_block_train(p_, x_, cfg), x,
                           use_reentrant=False)
        else:
            x = _dense_block_train(p, x, cfg)
    shared = None
    for i in range(n):
        if before_layer is not None:
            before_layer(k + i)
        if i == 0 and "shared" in params:
            shared = _resolved(params["shared"])
        p = _layer(params["blocks"], i)
        if cfg.remat:
            x, aux = checkpoint(
                lambda x_, a_, p_=p: _superblock_train(p_, x_, a_, cfg, kinds, shared),
                x, aux, use_reentrant=False,
            )
        else:
            x, aux = _superblock_train(p, x, aux, cfg, kinds, shared)
    if before_layer is not None:
        before_layer(k + n)
    final_norm = {k: resolve(v) for k, v in params["final_norm"].items()}
    return rmsnorm(final_norm, x, cfg.norm_eps), aux


# ---------------------------------------------------------------------------
# decode (one token, stacked caches read row by row beside the params)
# ---------------------------------------------------------------------------

def _cache_one(cfg, kind, window, batch, max_len, device) -> dict:
    if kind == "attn":
        return attn.init_cache(cfg, batch, max_len, window=window, device=device)
    if kind == "mamba":
        return ssm_mod.ssm_state_init(cfg, batch, device=device)
    if kind == "mlstm":
        return xlstm_mod.mlstm_state_init(cfg, batch, device=device)
    if kind == "slstm":
        return xlstm_mod.slstm_state_init(cfg, batch, device=device)
    raise ValueError(kind)


def init_caches(cfg, batch: int, max_len: int, *, device) -> dict:
    """The caches stacked over superblocks, ``{"blocks": {"b{j}": {"k":
    (n, B, T, K, hd), ...}}}`` as in the reference (the batch axis is 1):
    an attention block's KV cache, a recurrent block's state; with the
    shared block, ``"shared"``, one KV cache for each of its ``n``
    applications.  Zeros, or shapes only on the ``meta`` device.  A stack
    with a dense prefix raises ``NotImplementedError``: its only config,
    moonlight's, has latent attention, whose cache the port lacks."""
    attn._refuse_mla(cfg)
    if dense_prefix(cfg):
        raise NotImplementedError(f"{cfg.name}: decoding a dense prefix is not ported")
    n = num_superblocks(cfg)

    def stacked(kind, window):
        one = _cache_one(cfg, kind, window, batch, max_len, "meta")
        return {k: torch.zeros((n,) + tuple(v.shape), dtype=v.dtype, device=device)
                for k, v in one.items()}

    out = {"blocks": {f"b{j}": stacked(kind, window)
                      for j, (kind, window) in enumerate(superblock_kinds(cfg))}}
    if has_shared_block(cfg):
        out["shared"] = stacked("attn", 0)
    return out


def _attn_block_decode(p, x, cache, pos, cfg, window):
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
    return x + y


def _block_decode(p, x, cache, pos, cfg, kind, window):
    """One block's decode step; the cache rows (views) are written in
    place, the KV row at ``pos`` or the whole recurrent state."""
    if kind == "attn":
        return _attn_block_decode(p, x, cache, pos, cfg, window)
    if kind == "mamba":
        y, new = ssm_mod.ssm_decode(p["ssm"], rmsnorm(p["ln"], x, cfg.norm_eps), cache, cfg)
    elif kind == "mlstm":
        y, new = xlstm_mod.mlstm_decode(p, x, cache, cfg)
    elif kind == "slstm":
        y, new = xlstm_mod.slstm_decode(p, x, cache, cfg)
    else:
        raise ValueError(kind)
    for k, v in new.items():
        cache[k].copy_(v)
    return x + y


def stack_decode(params, x: torch.Tensor, caches: dict, pos: torch.Tensor, cfg):
    """x: (B, 1, d); pos: (B,).  Each superblock reads its parameter rows
    and writes its cache rows (views of the stacked caches) in place, then
    the shared block, when there is one, its own KV cache row.  Returns
    ``(y, caches)``."""
    kinds = superblock_kinds(cfg)
    shared = _resolved(params["shared"]) if "shared" in params else None
    for i in range(num_superblocks(cfg)):
        p = _layer(params["blocks"], i)
        for j, (kind, window) in enumerate(kinds):
            rows = {k: v[i] for k, v in caches["blocks"][f"b{j}"].items()}
            x = _block_decode(p[f"b{j}"], x, rows, pos, cfg, kind, window)
        if shared is not None:
            rows = {k: v[i] for k, v in caches["shared"].items()}
            x = _attn_block_decode(shared, x, rows, pos, _shared_sub_cfg(cfg), 0)
    final_norm = {k: resolve(v) for k, v in params["final_norm"].items()}
    return rmsnorm(final_norm, x, cfg.norm_eps), caches
