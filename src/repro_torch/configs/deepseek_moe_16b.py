"""deepseek-moe-16b [moe] — fine-grained MoE: 2 shared + 64 routed experts,
top-6 routing [arXiv:2401.06066].

28L, d_model=2048, 16 heads (kv=16), per-expert d_ff=1408, vocab=102400.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    tie_embeddings=False,
    source="arXiv:2401.06066",
)

REDUCED = CONFIG.with_(
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=96,
    vocab_size=512,
    num_experts=4,
    num_shared_experts=1,
    experts_per_token=2,
    compute_dtype="float32",
    remat=False,
    attn_chunk=32,
    xent_chunk=32,
)
