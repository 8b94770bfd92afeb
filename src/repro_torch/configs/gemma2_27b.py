"""gemma2-27b [dense] — alternating local/global attention, logit softcaps
[arXiv:2408.00118].

46L, d_model=4608, 32 heads (GQA kv=16, head_dim=128), d_ff=36864,
vocab=256000.  Superblock = (local window 4096, global) pair -> 23 scanned
superblocks.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    mlp_act="geglu",
    local_global=True,
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)

REDUCED = CONFIG.with_(
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    sliding_window=16,
    compute_dtype="float32",
    remat=False,
    attn_chunk=32,
    xent_chunk=32,
)
