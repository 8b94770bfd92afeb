"""moonlight-16b-a3b [moe] — DeepSeek-V3's architecture at 16B: multi-head
latent attention, a sigmoid-scored router over 64 routed experts (top-6,
2 shared), one leading dense layer
[huggingface.co/moonshotai/Moonlight-16B-A3B].

27L, d_model=2048, 16 heads; MLA with kv_lora_rank=512, no query latent,
qk_nope/rope/v head dims 128/64/128; dense MLP 11264, experts 1408;
vocab=163840, rope theta 50000.  The port has it and the JAX reference
does not (``configs.PORT_ONLY``).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonlight-16b-a3b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    aux_loss_coef=0.001,
    scoring_func="sigmoid",
    routed_scaling_factor=2.446,
    first_k_dense_replace=1,
    intermediate_size=11264,
    kv_lora_rank=512,
    q_lora_rank=0,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=50000.0,
    norm_eps=1e-5,
    tie_embeddings=False,
    source="huggingface.co/moonshotai/Moonlight-16B-A3B",
)

REDUCED = CONFIG.with_(
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=8,
    d_ff=32,
    vocab_size=512,
    num_experts=8,
    num_shared_experts=1,
    experts_per_token=2,
    intermediate_size=96,
    kv_lora_rank=16,
    qk_nope_head_dim=8,
    qk_rope_head_dim=4,
    v_head_dim=8,
    compute_dtype="float32",
    remat=False,
    attn_chunk=32,
    xent_chunk=32,
)
