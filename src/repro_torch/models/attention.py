"""Causal self-attention with RoPE, q-chunked, with an f32 softmax — the
training path of ``repro.models.attention.attn_train``: MHA/GQA/MQA, the
optional q/k/v biases (``qkv_bias``), the attention-logit softcap
(``attn_softcap``) and a sliding window.  No KV cache: decode waits for
serving."""
from __future__ import annotations

import torch

from .layers import rope, softcap

NEG_INF = -2.0e38


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
    """q: (B,Sq,K,G,hd)  k/v: (B,T,K,hd)  mask: (Sq,T) bool.
    Returns (B,Sq,K,G,hd).  The softcap applies to the scaled f32 scores,
    before the mask."""
    scale = cfg.head_dim ** -0.5
    s = torch.einsum("bqkgh,btkh->bkgqt", q, k).float() * scale
    s = softcap(s, cfg.attn_softcap)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgqt,btkh->bqkgh", p, v)


def attn_train(params, x: torch.Tensor, cfg, *, window: int = 0) -> torch.Tensor:
    """Causal self-attention over a full sequence, in q-chunks of
    ``cfg.attn_chunk`` (the whole sequence when it does not divide).
    ``window > 0`` restricts query ``q`` to keys ``t`` in ``(q - window,
    q]``."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    q, k, v = _qkv(params, x, cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = q.reshape(B, S, K, G, hd)

    chunk = min(cfg.attn_chunk, S)
    if S % chunk != 0:
        chunk = S
    t_idx = torch.arange(S, device=x.device)
    outs = []
    for off in range(0, S, chunk):
        q_idx = off + torch.arange(chunk, device=x.device)
        mask = t_idx[None, :] <= q_idx[:, None]
        if window > 0:
            mask &= t_idx[None, :] > (q_idx[:, None] - window)
        outs.append(_scores_softmax_value(q[:, off:off + chunk], k, v, mask, cfg))
    out = torch.cat(outs, dim=1).reshape(B, S, H * hd)
    cd = getattr(torch, cfg.compute_dtype)
    return out @ params["wo"].to(cd)
