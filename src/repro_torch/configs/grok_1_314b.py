"""grok-1-314b [moe] — 8 experts, top-2 routing [hf:xai-org/grok-1].

64L, d_model=6144, 48 heads (GQA kv=8, head_dim=128), d_ff=32768,
vocab=131072.  bf16 params/optimizer state (DESIGN SS8 memory note).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    num_shared_experts=0,
    experts_per_token=2,
    tie_embeddings=False,
    param_dtype="bfloat16",
    source="hf:xai-org/grok-1",
)

REDUCED = CONFIG.with_(
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    num_experts=4,
    experts_per_token=2,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
    attn_chunk=32,
    xent_chunk=32,
)
