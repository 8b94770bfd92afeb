"""pixtral-12b [vlm] — Pixtral-ViT frontend (stub) + Mistral-Nemo-style
backbone [hf:mistralai/Pixtral-12B-2409].

40L, d_model=5120, 32 heads (GQA kv=8, head_dim=128), d_ff=14336,
vocab=131072.  The ViT frontend is a stub: the backbone consumes
precomputed patch embeddings through a learned d_model x d_model
projector and prepends them to the text embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    modality="vision",
    frontend_tokens=256,
    source="hf:mistralai/Pixtral-12B-2409",
)

REDUCED = CONFIG.with_(
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    frontend_tokens=8,
    compute_dtype="float32",
    remat=False,
    attn_chunk=32,
    xent_chunk=32,
)
