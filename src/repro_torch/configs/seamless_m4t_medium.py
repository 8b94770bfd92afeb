"""seamless-m4t-medium [audio] — encoder-decoder, multimodal
[arXiv:2308.11596].

12 encoder + 12 decoder layers, d_model=1024, 16 heads (kv=16, head_dim=64),
d_ff=4096, vocab=256206 (padded to 256256).  The mel+conv speech frontend
is a stub: the encoder consumes precomputed frame embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    encoder_layers=12,
    is_encdec=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    mlp_act="gelu",
    modality="audio",
    frontend_tokens=1024,
    tie_embeddings=False,
    source="arXiv:2308.11596",
)

REDUCED = CONFIG.with_(
    num_layers=2,
    encoder_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    frontend_tokens=16,
    compute_dtype="float32",
    remat=False,
    attn_chunk=32,
    xent_chunk=32,
)
