"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

12L, d_model=768, 4 heads, vocab=50304 (GPT-NeoX tokenizer).  d_ff=0: the
xLSTM block carries its own expansion (mLSTM up-projection factor 2).
Block ratio 3:1 mLSTM:sLSTM (the paper's xLSTM[7:1] rounded to the
12-layer budget), as the reference adapts it.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    slstm_every=4,
    tie_embeddings=True,
    source="arXiv:2405.04517",
)

REDUCED = CONFIG.with_(
    num_layers=2,
    d_model=128,
    num_heads=2,
    num_kv_heads=2,
    head_dim=64,
    vocab_size=512,
    slstm_every=2,
    compute_dtype="float32",
    remat=False,
    attn_chunk=32,
    xent_chunk=32,
)
