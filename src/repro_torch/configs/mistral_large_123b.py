"""mistral-large-123b [dense] [hf:mistralai/Mistral-Large-Instruct-2407].

88L, d_model=12288, 96 heads (GQA kv=8, head_dim=128), d_ff=28672,
vocab=32768.  bf16 params/optimizer state (DESIGN SS8 memory note).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)

REDUCED = CONFIG.with_(
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab_size=512,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
    attn_chunk=32,
    xent_chunk=32,
)
