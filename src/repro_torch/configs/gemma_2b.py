"""gemma-2b [dense] — GeGLU MLP, MQA (kv=1), head_dim=256 [arXiv:2403.08295].

18L, d_model=2048, 8 heads, d_ff=16384, vocab=256000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_act="geglu",
    tie_embeddings=True,   # reference ties; we untie for vocab sharding (DESIGN SS8)
    source="arXiv:2403.08295",
)

REDUCED = CONFIG.with_(
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    compute_dtype="float32",
    remat=False,
    attn_chunk=32,
    xent_chunk=32,
)
