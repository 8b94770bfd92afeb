"""Causal self-attention with RoPE and an f32 softmax — the counterpart of
``repro.models.attention``: MHA/GQA/MQA, the optional q/k/v biases
(``qkv_bias``), the attention-logit softcap (``attn_softcap``) and a
sliding window, on two paths:

* training and prefill (``attn_train``): the whole sequence, through the
  hand-written causal kernel on the card and q-chunked elsewhere;
* decode (``attn_decode``): one token per slot against a KV cache, linear
  in ``max_len``, or rolling (slot ``pos % T``) for a windowed layer, so
  its state is O(window).  ``kv_cache_dtype="int8"`` stores keys and
  values quantised per (slot, position, head) with a bf16 scale.

The decode step writes the new token's row into the cache in place.

Multi-head latent attention (MLA, DeepSeek-V2/V3; ``cfg.kv_lora_rank >
0``) trains on the same path (``mla_train``): per head the query
is ``[q_nope | q_rope]`` from ``x W_q``; ``[c | k_r] = x W_kva``, the
latent ``c`` RMS-normed and up-projected by ``W_kvb`` to per-head
``[k_nope | v]``; the one rotary key ``k_r`` is shared by every head;
scores at ``(nope + rope) ** -0.5`` over keys ``[k_nope | k_r]``, values
``v_head_dim`` wide.  Decoding it needs a latent cache, which the port
lacks: ``init_cache`` and ``attn_decode`` refuse it."""
from __future__ import annotations

import torch

from ..kernels.causal_attn import causal_attn
from ..obs.spans import span
from .layers import rmsnorm, rope, softcap

NEG_INF = -2.0e38
# the latent's RMSNorm: DeepSeek-V2/V3 build it at the norm's default eps,
# not at the config's ``rms_norm_eps``
LATENT_NORM_EPS = 1e-6


def _qkv(params, x, cfg):
    cd = getattr(torch, cfg.compute_dtype)
    xc = x.to(cd)
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = xc @ params["wq"].to(cd)
    k = xc @ params["wk"].to(cd)
    v = xc @ params["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + params["bq"].to(cd)
        k = k + params["bk"].to(cd)
        v = v + params["bv"].to(cd)
    return (
        q.reshape(B, S, H, hd),
        k.reshape(B, S, K, hd),
        v.reshape(B, S, K, hd),
    )


def _scores_softmax_value(q, k, v, mask, cfg):
    """q: (B,Sq,K,G,hq)  k: (B,T,K,hq)  v: (B,T,K,hv)  mask: bool, broadcast
    against the (B,K,G,Sq,T) scores: (Sq,T) for training, (B,1,1,1,T) for
    decode; ``None`` for a full mask (the encoder and cross-attention),
    which the reference's all-true mask leaves unchanged.  Returns
    (B,Sq,K,G,hv).  The scores' scale is ``hq ** -0.5`` (``head_dim``, or
    MLA's query/key width); the softcap applies to the scaled f32 scores,
    before the mask."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgh,btkh->bkgqt", q, k).float() * scale
    s = softcap(s, cfg.attn_softcap)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgqt,btkv->bqkgv", p, v)


def _attend(q, k, v, cfg, window: int):
    """Causal attention of q (B,S,K,G,hq) over k (B,S,K,hq) and v
    (B,S,K,hv) -> (B,S,K,G,hv); ``window > 0`` restricts query ``q`` to
    keys ``t`` in ``(q - window, q]``.  CUDA tensors go to the hand-written
    kernel (``kernels/causal_attn.py``), any other to the plain q-chunked
    path (:func:`_attend_plain`)."""
    if q.is_cuda:
        return causal_attn(q, k, v, window=window, softcap=cfg.attn_softcap)
    return _attend_plain(q, k, v, cfg, window)


def _attend_plain(q, k, v, cfg, window: int):
    """:func:`_attend` in q-chunks of ``cfg.attn_chunk`` (the whole sequence
    when it does not divide): every chunk's scores over every key, an f32
    softmax, the causal (and window) mask applied to the scores."""
    S = q.shape[1]
    chunk = min(cfg.attn_chunk, S)
    if S % chunk != 0:
        chunk = S
    t_idx = torch.arange(S, device=q.device)
    outs = []
    for off in range(0, S, chunk):
        q_idx = off + torch.arange(chunk, device=q.device)
        mask = t_idx[None, :] <= q_idx[:, None]
        if window > 0:
            mask &= t_idx[None, :] > (q_idx[:, None] - window)
        outs.append(_scores_softmax_value(q[:, off:off + chunk], k, v, mask, cfg))
    return torch.cat(outs, dim=1)


def attn_train(params, x: torch.Tensor, cfg, *, window: int = 0) -> torch.Tensor:
    """Causal self-attention over a full sequence (:func:`_attend`); MLA
    for a config with ``kv_lora_rank`` (:func:`mla_train`)."""
    if cfg.is_mla:
        return mla_train(params, x, cfg, window=window)
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    q, k, v = _qkv(params, x, cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = q.reshape(B, S, K, G, hd)
    out = _attend(q, k, v, cfg, window).reshape(B, S, H * hd)
    cd = getattr(torch, cfg.compute_dtype)
    return out @ params["wo"].to(cd)


# ---------------------------------------------------------------------------
# multi-head latent attention (training and prefill)
# ---------------------------------------------------------------------------

def mla_param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """One MLA block's ``attn`` leaves (one row), by path under it."""
    if cfg.q_lora_rank:
        raise NotImplementedError("MLA with a query latent (q_lora_rank > 0) is not ported")
    d, H, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    nope, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": (d, H * (nope + rd)),
        "wkv_a": (d, r + rd),
        "kv_norm.scale": (r,),
        "wkv_b": (r, H * (nope + vd)),
        "wo": (H * vd, d),
    }


def _mla_qkv(params, x, cfg):
    """-> q, k (B,S,H,nope+rope), v (B,S,H,v_head_dim), rotated."""
    cd = getattr(torch, cfg.compute_dtype)
    B, S, _ = x.shape
    H, r = cfg.num_heads, cfg.kv_lora_rank
    nope, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    xc = x.to(cd)
    q = (xc @ params["wq"].to(cd)).reshape(B, S, H, nope + rd)
    kv_a = xc @ params["wkv_a"].to(cd)
    c = rmsnorm(params["kv_norm"], kv_a[..., :r], LATENT_NORM_EPS)
    kv = (c @ params["wkv_b"].to(cd)).reshape(B, S, H, nope + vd)
    positions = torch.arange(S, device=x.device)[None, :]
    q_rope = rope(q[..., nope:], positions, cfg.rope_theta)
    k_rope = rope(kv_a[..., None, r:], positions, cfg.rope_theta)  # one head
    q = torch.cat([q[..., :nope], q_rope], dim=-1)
    k = torch.cat([kv[..., :nope], k_rope.expand(B, S, H, rd)], dim=-1)
    return q, k, kv[..., nope:]


def mla_train(params, x: torch.Tensor, cfg, *, window: int = 0) -> torch.Tensor:
    """Causal MLA over a full sequence: the projections, the latent's norm
    and RoPE in span ``mla/latent``, the scores, softmax and values
    (:func:`_attend`, every head its own key) in ``mla/attend``,
    then the output projection."""
    B, S, _ = x.shape
    H = cfg.num_heads
    with span("mla/latent"):
        q, k, v = _mla_qkv(params, x, cfg)
    with span("mla/attend"):
        out = _attend(q[:, :, :, None], k, v, cfg, window)
    cd = getattr(torch, cfg.compute_dtype)
    return out.reshape(B, S, H * cfg.v_head_dim) @ params["wo"].to(cd)


def _refuse_mla(cfg) -> None:
    if cfg.is_mla:
        raise NotImplementedError(
            f"{cfg.name}: decoding multi-head latent attention needs a latent "
            f"cache (the normed kv_lora_rank latent and the shared rotary key "
            f"per position), which the port does not have")


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def _cache_dtype(cfg) -> torch.dtype:
    if cfg.kv_cache_dtype == "int8":
        return torch.int8
    return getattr(torch, cfg.kv_cache_dtype or cfg.compute_dtype)


def init_cache(cfg, batch: int, max_len: int, *, window: int = 0, device) -> dict:
    """Rolling cache for a windowed layer (``T = min(window, max_len)``),
    linear otherwise; zeros.  With ``kv_cache_dtype="int8"`` keys and
    values are int8 with a bf16 scale per (slot, position, head).  On the
    ``meta`` device it is the shapes and dtypes only (``cache_specs``).  An
    MLA config raises ``NotImplementedError``: it needs a latent cache."""
    _refuse_mla(cfg)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    T = min(window, max_len) if window > 0 else max_len
    dt = _cache_dtype(cfg)
    c = {
        "k": torch.zeros((batch, T, K, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, T, K, hd), dtype=dt, device=device),
    }
    if cfg.kv_cache_dtype == "int8":
        c["k_scale"] = torch.zeros((batch, T, K), dtype=torch.bfloat16, device=device)
        c["v_scale"] = torch.zeros((batch, T, K), dtype=torch.bfloat16, device=device)
    return c


def cache_specs(cfg, batch: int, max_len: int, *, window: int = 0) -> dict:
    """:func:`init_cache`'s shapes and dtypes as ``meta`` tensors."""
    return init_cache(cfg, batch, max_len, window=window, device="meta")


def _quantize_kv(x: torch.Tensor):
    """x: (B, K, hd) -> (int8 payload, (B, K) bf16 scale):
    ``round(x / max(amax/127, 1e-8))`` clipped to +-127, round half to
    even as ``jnp.round``."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def attn_decode(params, x: torch.Tensor, cache: dict, pos: torch.Tensor, cfg, *,
                window: int = 0):
    """One decode step.  x: (B, 1, d); pos: (B,) absolute position of the
    new token.  Writes the token's key and value into ``cache`` in place
    (row ``pos``, or ``pos % T`` for a windowed layer) and returns
    ``(y (B,1,d), cache)``.  An MLA config raises ``NotImplementedError``."""
    _refuse_mla(cfg)
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    T = cache["k"].shape[1]
    q, k, v = _qkv(params, x, cfg)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)

    slot = torch.remainder(pos, T) if window > 0 else pos
    b_idx = torch.arange(B, device=x.device)
    if cfg.kv_cache_dtype == "int8":
        qk, sk = _quantize_kv(k[:, 0])
        qv, sv = _quantize_kv(v[:, 0])
        cache["k"][b_idx, slot] = qk
        cache["v"][b_idx, slot] = qv
        cache["k_scale"][b_idx, slot] = sk
        cache["v_scale"][b_idx, slot] = sv
        new_k = _dequantize_kv(cache["k"], cache["k_scale"], k.dtype)
        new_v = _dequantize_kv(cache["v"], cache["v_scale"], v.dtype)
    else:
        cache["k"][b_idx, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][b_idx, slot] = v[:, 0].to(cache["v"].dtype)
        new_k, new_v = cache["k"], cache["v"]

    t_idx = torch.arange(T, device=x.device)[None, :]
    if window > 0:
        valid = t_idx <= torch.clamp(pos, max=T - 1)[:, None]
    else:
        valid = t_idx <= pos[:, None]
    mask = valid[:, None, None, None, :]  # (B,1,1,1,T)

    qh = q.reshape(B, 1, K, G, hd)
    if new_k.dtype != qh.dtype:  # a cache dtype other than the compute dtype
        dt = torch.promote_types(qh.dtype, new_k.dtype)
        qh, new_k, new_v = qh.to(dt), new_k.to(dt), new_v.to(dt)
    out = _scores_softmax_value(qh, new_k, new_v, mask, cfg)
    out = out.reshape(B, 1, H * hd)
    dt = torch.promote_types(out.dtype, getattr(torch, cfg.compute_dtype))
    return out.to(dt) @ params["wo"].to(dt), cache
