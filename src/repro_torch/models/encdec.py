"""The encoder-decoder transformer (the seamless-m4t backbone) — the
counterpart of ``repro.models.encdec``.

Encoder: bidirectional self-attention (RoPE on q and k at ``arange(S)``,
no mask) over the stub frontend's frame embeddings, then ``enc_norm``.
Decoder: causal self-attention, cross-attention to the encoder memory (no
mask) and the MLP, then ``final_norm``.  In training every decoder layer
projects the memory into its own keys and values; the decode path projects
them once a request (:func:`precompute_memory_kv`) into the caches'
``mem_k``/``mem_v`` and caches the decoder's self-attention keys and
values as the decoder families do.

The parameters are the reference's: ``encoder.*`` stacked over the
``encoder_layers`` rows, ``decoder.*`` over the ``num_layers`` rows, read
row by row by the layer loops (a row may be a deferred tensor,
``transformer.resolve``).  ``cfg.remat`` checkpoints each layer, as the
reference rematerialises each scan body.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .attention import _qkv, _scores_softmax_value
from .layers import mlp, rmsnorm, rope
from .transformer import _attn_param_shapes, _layer, _resolved


def _cd(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _attn_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """One attention's leaves (``wq``, ``wk``, ``wv``, ``wo`` and, with
    ``qkv_bias``, the biases), by name."""
    return {k.removeprefix("attn."): s for k, s in _attn_param_shapes(cfg).items()
            if k.startswith("attn.")}


def _mlp_shapes(cfg) -> dict[str, tuple[int, ...]]:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def enc_block_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """One encoder layer's leaf shapes (one row), by path under it."""
    d = cfg.d_model
    return {**{f"attn.{k}": s for k, s in _attn_shapes(cfg).items()},
            "ln1.scale": (d,), "ln2.scale": (d,),
            **{f"mlp.{k}": s for k, s in _mlp_shapes(cfg).items()}}


def dec_block_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """One decoder layer's leaf shapes (one row): the encoder layer's and
    the cross-attention ``xattn`` with its norm ``lnx``."""
    return {**enc_block_shapes(cfg), "lnx.scale": (cfg.d_model,),
            **{f"xattn.{k}": s for k, s in _attn_shapes(cfg).items()}}


def encdec_param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """The backbone's leaf shapes, keyed by their path under ``encdec``."""
    E, L, d = cfg.encoder_layers, cfg.num_layers, cfg.d_model
    shapes = {f"encoder.{k}": (E,) + s for k, s in enc_block_shapes(cfg).items()}
    shapes.update({f"decoder.{k}": (L,) + s for k, s in dec_block_shapes(cfg).items()})
    shapes["enc_norm.scale"] = (d,)
    shapes["final_norm.scale"] = (d,)
    return shapes


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _memory_kv(params, memory: torch.Tensor, cfg):
    """The memory (B, T, d) projected into keys and values (B, T, K, hd)
    in the compute dtype."""
    cd = _cd(cfg)
    B, T, _ = memory.shape
    K, hd = cfg.num_kv_heads, cfg.head_dim
    m = memory.to(cd)
    k = m @ params["wk"].to(cd)
    v = m @ params["wv"].to(cd)
    return k.reshape(B, T, K, hd), v.reshape(B, T, K, hd)


def cross_attn(params, x: torch.Tensor, mem_k: torch.Tensor, mem_v: torch.Tensor,
               cfg) -> torch.Tensor:
    """x: (B, S, d); mem_k/mem_v: (B, T, K, hd).  Every query sees every
    memory position (no mask, no RoPE)."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cd = _cd(cfg)
    q = (x.to(cd) @ params["wq"].to(cd)).reshape(B, S, K, H // K, hd)
    out = _scores_softmax_value(q, mem_k, mem_v, None, cfg).reshape(B, S, H * hd)
    return out @ params["wo"].to(cd)


def _bidir_attn(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The encoder's self-attention: RoPE at ``arange(S)``, no mask."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv(params, x, cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = _scores_softmax_value(q.reshape(B, S, K, H // K, hd), k, v, None, cfg)
    return out.reshape(B, S, H * hd) @ params["wo"].to(_cd(cfg))


# ---------------------------------------------------------------------------
# training and prefill
# ---------------------------------------------------------------------------

def _enc_block(p, x, cfg):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + _bidir_attn(p["attn"], h, cfg)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.mlp_act, _cd(cfg))


def _dec_block(p, x, memory, cfg, window):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn.attn_train(p["attn"], h, cfg, window=window)
    h = rmsnorm(p["lnx"], x, cfg.norm_eps)
    mk, mv = _memory_kv(p["xattn"], memory, cfg)
    x = x + cross_attn(p["xattn"], h, mk, mv, cfg)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.mlp_act, _cd(cfg))


def encode(params, frames: torch.Tensor, cfg, before_layer=None) -> torch.Tensor:
    """frames: (B, T, d) -> memory (B, T, d).  ``before_layer(i)``, when
    given, is called before encoder row ``i`` is read and, with ``i =
    encoder_layers``, before ``enc_norm``; like the decoder stack's, it and
    the read of the rows run outside the checkpointed layer."""
    x = frames.to(_cd(cfg))
    E = cfg.encoder_layers
    for i in range(E):
        if before_layer is not None:
            before_layer(i)
        p = _layer(params["encoder"], i)
        if cfg.remat:
            x = checkpoint(lambda x_, p_=p: _enc_block(p_, x_, cfg), x,
                           use_reentrant=False)
        else:
            x = _enc_block(p, x, cfg)
    if before_layer is not None:
        before_layer(E)
    return rmsnorm(_resolved(params["enc_norm"]), x, cfg.norm_eps)


def decode_train(params, x: torch.Tensor, memory: torch.Tensor, cfg, *,
                 window: int = 0, before_layer=None) -> torch.Tensor:
    """The teacher-forced decoder: x (B, S, d) token embeddings, memory
    (B, T, d) -> (B, S, d) after ``final_norm``.  ``before_layer(r)`` is
    called before decoder row ``r`` is read and, with ``r = num_layers``,
    before ``final_norm``."""
    x = x.to(_cd(cfg))
    L = cfg.num_layers
    for r in range(L):
        if before_layer is not None:
            before_layer(r)
        p = _layer(params["decoder"], r)
        if cfg.remat:
            x = checkpoint(lambda x_, m_, p_=p: _dec_block(p_, x_, m_, cfg, window),
                           x, memory, use_reentrant=False)
        else:
            x = _dec_block(p, x, memory, cfg, window)
    if before_layer is not None:
        before_layer(L)
    return rmsnorm(_resolved(params["final_norm"]), x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def dec_caches(cfg, batch: int, max_len: int, memory_len: int, *, window: int = 0,
               device) -> dict:
    """``{"self": {"k": (L, B, max_len, K, hd), ...}, "mem_k": (L, B,
    memory_len, K, hd), "mem_v": ...}``: the decoder's self-attention
    cache (``attn.init_cache``, its int8 form included) stacked over the
    ``L`` decoder rows, and the memory's keys and values in the compute
    dtype.  Zeros, or shapes only on the ``meta`` device."""
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    one = attn.init_cache(cfg, batch, max_len, window=window, device="meta")
    out = {"self": {k: torch.zeros((L,) + tuple(v.shape), dtype=v.dtype, device=device)
                    for k, v in one.items()}}
    for k in ("mem_k", "mem_v"):
        out[k] = torch.zeros((L, batch, memory_len, K, hd), dtype=_cd(cfg), device=device)
    return out


def precompute_memory_kv(params, memory: torch.Tensor, cfg):
    """Every decoder row's cross-attention keys and values of ``memory``,
    once a request: ``(mem_k, mem_v)``, each (L, B, T, K, hd)."""
    kv = [_memory_kv(_layer(params["decoder"], r)["xattn"], memory, cfg)
          for r in range(cfg.num_layers)]
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])


def decode_step(params, x: torch.Tensor, caches: dict, pos: torch.Tensor, cfg, *,
                window: int = 0):
    """x: (B, 1, d); pos: (B,).  Each decoder row writes its self-attention
    cache row at ``pos`` in place and attends to its ``mem_k``/``mem_v``
    rows.  Returns ``(y (B, 1, d) after final_norm, caches)``."""
    x = x.to(_cd(cfg))
    for r in range(cfg.num_layers):
        p = _layer(params["decoder"], r)
        rows = {k: v[r] for k, v in caches["self"].items()}
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        y, _ = attn.attn_decode(p["attn"], h, rows, pos, cfg, window=window)
        x = x + y
        h = rmsnorm(p["lnx"], x, cfg.norm_eps)
        x = x + cross_attn(p["xattn"], h, caches["mem_k"][r], caches["mem_v"][r], cfg)
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], h, cfg.mlp_act, _cd(cfg))
    return rmsnorm(_resolved(params["final_norm"]), x, cfg.norm_eps), caches


__all__ = [
    "cross_attn",
    "dec_block_shapes",
    "dec_caches",
    "decode_step",
    "decode_train",
    "enc_block_shapes",
    "encdec_param_shapes",
    "encode",
    "precompute_memory_kv",
]
