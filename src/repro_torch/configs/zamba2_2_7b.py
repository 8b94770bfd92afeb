"""zamba2-2.7b [hybrid] — Mamba2 backbone + weight-shared attention block
[arXiv:2411.15242].

54 Mamba2 layers, d_model=2560, ssm_state=64; one shared transformer block
(32 heads, kv=32, d_ff=10240) applied every 6 mamba blocks (9 applications,
shared weights).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    tie_embeddings=True,
    source="arXiv:2411.15242",
)

REDUCED = CONFIG.with_(
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=32,
    attn_every=2,
    compute_dtype="float32",
    remat=False,
    attn_chunk=32,
    xent_chunk=32,
)
