"""The FLOPs a training step needs, in closed form from the configuration
and the batch: a multiply-add is 2 FLOPs; the backward pass is twice the
forward; attention counts the causal half of its scores and values; a
mixture of experts counts the router and the active experts only (``k``
routed plus the shared ones), not the capacity's padding; the embedding's
gather is free; nothing recomputed for memory counts.  Covers the decoders
of the attention families (dense and MoE)."""
from __future__ import annotations

import math


def _padded_vocab(vocab: int) -> int:
    return int(math.ceil(vocab / 128) * 128)


def step_flops(conf: dict, *, rows: int, seq_len: int) -> float:
    """The global FLOPs of one training step over ``rows`` rows (every
    worker's) of ``seq_len`` tokens."""
    B, S = rows, seq_len
    d = conf["d_model"]
    H, K = conf["num_heads"], conf["num_kv_heads"]
    hd = conf.get("head_dim") or d // H
    proj = 2.0 * B * S * d * (2 * H * hd + 2 * K * hd)
    attn = 2.0 * 2.0 * B * S * H * hd * (S / 2.0)
    if conf.get("num_experts", 0) > 0:
        active = conf["experts_per_token"] + conf.get("num_shared_experts", 0)
        ffn = 2.0 * B * S * (d * conf["num_experts"] + active * 3 * d * conf["d_ff"])
    else:
        ffn = 2.0 * B * S * 3 * d * conf["d_ff"]
    head = 2.0 * B * S * d * _padded_vocab(conf["vocab_size"])
    return 3.0 * (conf["num_layers"] * (proj + attn + ffn) + head)
