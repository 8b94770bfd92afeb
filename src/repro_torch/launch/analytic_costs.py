"""Analytic per-step cost models for the roofline, the counterpart of
``repro.launch.analytic_costs``: the same closed forms from the config and
the shape, so the port gives the same floats as the reference for every
arch and every shape.

The reference needs them because XLA's ``cost_analysis()`` counts a
while-loop body once; the port needs them because an eager step has no
compiled cost model at all.  The dry run (``launch.dryrun``) prices them on
the H100 (``core.ccr.HardwareSpec.h100_sxm``).

Conventions: a MAC counts as 2 FLOPs; the backward pass is 2x the forward
for matrix products; attention counts the causal 1/2 factor; MoE counts the
active experts only.  The port's own mechanisms (moonlight's) count the
same way: latent attention its four projections and its scores and values
at the query/key and value widths, an MoE stack's leading dense layers
their attention and MLP, a held share of the experts its expected load
(``k`` of the router's ``E`` a token, ``num_experts / E`` of them here).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig, InputShape
from ..models import count_params, padded_vocab
from ..models.transformer import (
    dense_prefix,
    has_shared_block,
    num_superblocks,
    superblock_kinds,
)


def _attn_flops_per_layer(cfg, B, S, kv_len, window, kind) -> float:
    """Score + value matmul flops for one attention layer (MLA: scores at
    the query/key width, values at ``v_head_dim``)."""
    H = cfg.num_heads
    if cfg.is_mla:
        widths = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim
    else:
        widths = 2 * cfg.head_dim
    if kind == "decode":
        ctx = min(window, kv_len) if window else kv_len
        return 2.0 * B * H * widths * ctx  # q*K^T + p*V for 1 token
    ctx = min(window, S) if window else S
    # causal: average context ~ ctx/2 (window caps it)
    avg = ctx / 2.0 if not window else max(window / 2.0, 1.0)
    return 2.0 * B * S * H * widths * avg


def _attn_proj_flops(cfg, B, S) -> float:
    """One attention layer's projections: q, k, v and o, or MLA's q,
    kv_a, kv_b and o."""
    d, H = cfg.d_model, cfg.num_heads
    if cfg.is_mla:
        r, rd = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        qk, vd = cfg.qk_nope_head_dim + rd, cfg.v_head_dim
        return 2.0 * B * S * (d * H * qk + d * (r + rd) + r * H * (qk - rd + vd)
                              + H * vd * d)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return 2.0 * B * S * d * (2 * H * hd + 2 * K * hd)


def _dense_prefix_flops(cfg, B, S, kv_len, kind) -> float:
    """The leading dense layers of an MoE stack: attention and MLP."""
    per = (_attn_proj_flops(cfg, B, S) + _attn_flops_per_layer(cfg, B, S, kv_len, 0, kind)
           + 2.0 * B * S * 3 * cfg.d_model * cfg.intermediate_size)
    return dense_prefix(cfg) * per


def _layer_flops(cfg: ArchConfig, B: int, S: int, kv_len: int, kind: str) -> float:
    """Forward FLOPs of ONE superblock for B x S tokens."""
    d = cfg.d_model
    total = 0.0
    for bkind, window in superblock_kinds(cfg):
        if bkind == "attn":
            proj = _attn_proj_flops(cfg, B, S)
            total += proj + _attn_flops_per_layer(cfg, B, S, kv_len, window, kind)
            if cfg.is_moe:
                E = cfg.routed_experts
                act = cfg.experts_per_token * cfg.num_experts / E + cfg.num_shared_experts
                total += 2.0 * B * S * (d * E  # router
                                        + act * 3 * d * cfg.d_ff)
            else:
                total += 2.0 * B * S * 3 * d * cfg.d_ff
        elif bkind == "mamba":
            d_in = cfg.ssm_expand * d
            ds = cfg.ssm_state
            proj = 2.0 * B * S * d * (2 * d_in + 2 * ds + d_in // cfg.ssm_head_dim)
            ssd = 2.0 * B * S * d_in * 2 * ds          # state update + output
            total += proj + ssd + 2.0 * B * S * d_in * d  # out_proj
        elif bkind == "mlstm":
            d_in = 2 * d
            total += 2.0 * B * S * (d * 2 * d_in + 3 * d_in * d_in + d_in * d)
            hd = d_in // cfg.num_heads
            total += 2.0 * B * S * cfg.num_heads * (2 * hd * hd)
        elif bkind == "slstm":
            hd = d // cfg.num_heads
            total += 2.0 * B * S * (4 * d * d + 4 * cfg.num_heads * hd * hd + d * d)
    # zamba2 shared block applied once per superblock
    if has_shared_block(cfg):
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        d_ff = cfg.d_ff if cfg.d_ff > 0 else 4 * d
        total += 2.0 * B * S * (d * (2 * H * hd + 2 * K * hd) + 3 * d * d_ff)
        total += _attn_flops_per_layer(cfg, B, S, kv_len, 0, kind)
    return total


def step_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """Global fwd(+bwd for train) FLOPs for one step of this shape."""
    B = shape.global_batch
    kind = shape.kind
    S = 1 if kind == "decode" else shape.seq_len
    kv_len = shape.seq_len
    V = padded_vocab(cfg)
    d = cfg.d_model

    if cfg.is_encdec:
        # decoder layers are plain attention blocks (no superblock pattern)
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        proj = 2.0 * B * S * d * (2 * H * hd + 2 * K * hd)
        dec = cfg.num_layers * (
            proj
            + _attn_flops_per_layer(cfg, B, S, kv_len, cfg.sliding_window, kind)
            + 2.0 * B * S * 3 * d * cfg.d_ff
            + proj  # cross-attn projections
        )
        core = dec
    else:
        n_super = num_superblocks(cfg)
        core = n_super * _layer_flops(cfg, B, S, kv_len, kind)
        if dense_prefix(cfg):
            core += _dense_prefix_flops(cfg, B, S, kv_len, kind)
    if cfg.is_encdec:
        # encoder over the frontend frames (full bidirectional attention)
        Te = cfg.frontend_tokens
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        enc = cfg.encoder_layers * (
            2.0 * B * Te * (d * (2 * H * hd + 2 * K * hd) + 3 * d * cfg.d_ff)
            + 2.0 * 2.0 * B * Te * H * hd * Te
        )
        # cross attention per decoder layer
        core += enc + cfg.num_layers * 2.0 * 2.0 * B * S * H * hd * Te
    emb = 2.0 * B * S * d * V  # unembed matmul (embed lookup ~free)
    fwd = core + emb
    if kind == "train":
        return 3.0 * fwd  # bwd = 2x fwd
    return fwd


def step_hbm_bytes(cfg: ArchConfig, shape: InputShape, *, model_shard: int,
                   data_shard: int, weight_shard_extra: int = 1) -> float:
    """Per-device HBM traffic lower bound for one step.

    train:  params read twice (fwd+bwd) + grads written + Adam moments R/W
            + activation traffic with remat (~2x fwd writes+reads).
    serve:  weights read once + KV cache read(+write) + activations.

    The parameter dtype's size comes from the config's ``param_dtype``.
    """
    p_dtype = getattr(torch, cfg.param_dtype).itemsize
    n_params = count_params(cfg)
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    act_bytes = 2  # bf16 activations

    if shape.kind == "train":
        p_local = n_params * p_dtype / model_shard
        tokens_local = B * S / data_shard
        L = cfg.num_layers + cfg.encoder_layers
        # ~12 activation tensors of size (tokens, d) per layer, x2 for remat
        act = 2 * 12 * tokens_local * d * act_bytes * L
        return 3 * p_local + 3 * p_local + act  # params fwd/bwd/gradW + moments
    # serve
    shard = model_shard * data_shard * weight_shard_extra
    p_local = n_params * p_dtype / shard
    if shape.kind == "prefill":
        tokens_local = B * S / data_shard
        L = cfg.num_layers + cfg.encoder_layers
        act = 12 * tokens_local * d * act_bytes * L
        return p_local + act
    # decode: weights + full KV/state read per token
    cache = _cache_bytes(cfg, shape)
    return p_local + cache / (model_shard * data_shard)


def _cache_bytes(cfg, shape) -> float:
    B, S = shape.global_batch, shape.seq_len
    total = 0.0
    kv_itemsize = 1 if cfg.kv_cache_dtype == "int8" else 2
    if cfg.is_encdec:
        T = min(cfg.sliding_window, S) if cfg.sliding_window else S
        self_c = cfg.num_layers * 2 * B * T * cfg.num_kv_heads * cfg.head_dim * kv_itemsize
        cross = cfg.num_layers * 2 * B * cfg.frontend_tokens * \
            cfg.num_kv_heads * cfg.head_dim * 2
        return self_c + cross
    n_super = num_superblocks(cfg)
    for bkind, window in superblock_kinds(cfg):
        if bkind == "attn":
            T = min(window, S) if window else S
            total += (n_super * 2 * B * T * cfg.num_kv_heads
                      * cfg.head_dim * kv_itemsize)
        elif bkind == "mamba":
            d_in = cfg.ssm_expand * cfg.d_model
            H = d_in // cfg.ssm_head_dim
            total += n_super * B * H * cfg.ssm_head_dim * cfg.ssm_state * 4
        elif bkind in ("mlstm", "slstm"):
            d_in = 2 * cfg.d_model
            hd = d_in // cfg.num_heads
            total += n_super * B * cfg.num_heads * hd * hd * 4
    if has_shared_block(cfg):
        total += n_super * 2 * B * S * cfg.num_kv_heads * cfg.head_dim * 2
    return total
