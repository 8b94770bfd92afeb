"""gpt2-paper — the paper's own text-generation workload (Table VI: GPT-2,
THUC-News); the same dimensions as ``repro.configs.gpt2_paper``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gpt2-paper",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=50257,
    mlp_act="gelu",
    tie_embeddings=True,
    source="paper Table VI / radford2019gpt2",
)

REDUCED = CONFIG.with_(
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    compute_dtype="float32",
    remat=False,
    attn_chunk=32,
    xent_chunk=32,
)
