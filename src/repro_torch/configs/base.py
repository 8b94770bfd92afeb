"""Architecture config schema: the fields every family reads (dense, MoE,
SSM (xlstm), hybrid (zamba2), VLM (pixtral) and the encoder-decoder audio
family (seamless)), with the same defaults as
``repro.configs.base.ArchConfig`` (the serving field ``kv_cache_dtype``
included), and the named input shapes (``INPUT_SHAPES``).  The fields the
reference lacks (latent attention, the sigmoid router, a leading dense
layer, an expert share), named after the published DeepSeek-V3 keys,
leave every other configuration's path unchanged at their defaults."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # the router's width when the layer holds a share of the experts:
    # ``num_experts`` experts from ``first_expert`` on, of
    # ``n_routed_experts`` (0: all ``num_experts``, the whole layer)
    n_routed_experts: int = 0
    first_expert: int = 0
    scoring_func: str = "softmax"    # softmax | sigmoid (the DeepSeek-V3 router)
    routed_scaling_factor: float = 1.0   # sigmoid: the weights' factor
    first_k_dense_replace: int = 0   # leading dense layers of an MoE stack
    intermediate_size: int = 0       # their MLP width

    # --- multi-head latent attention (MLA; kv_lora_rank 0 = none) -------------
    kv_lora_rank: int = 0
    q_lora_rank: int | None = 0      # 0 or None: queries projected from x
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- attention ----------------------------------------------------------
    qkv_bias: bool = False
    logit_softcap: float = 0.0       # final-logit softcap (gemma2)
    attn_softcap: float = 0.0        # attention-logit softcap (gemma2)
    sliding_window: int = 0          # 0 = full attention
    local_global: bool = False       # gemma2 alternating local/global layers
    rope_theta: float = 10000.0
    # carried for parity with the reference config; like the reference
    # decoder, the port keeps an untied ``head.w`` and never reads it
    tie_embeddings: bool = True

    mlp_act: str = "swiglu"          # swiglu | geglu | gelu
    norm_eps: float = 1e-6

    # --- SSM / hybrid ---------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0              # zamba2: one shared attn block every N mamba
    slstm_every: int = 0             # xlstm: one sLSTM block every N mLSTM

    # --- encoder-decoder / modality -------------------------------------------
    encoder_layers: int = 0
    is_encdec: bool = False
    modality: str = "text"           # text | vision | audio
    frontend_tokens: int = 0         # patches/frames emitted by the stub frontend

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = ""         # "" = compute_dtype; "int8" = quantized
    remat: bool = True
    xent_chunk: int = 512            # sequence chunk for the softmax-xent loss
    attn_chunk: int = 256            # q-chunk for the streaming attention

    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def routed_experts(self) -> int:
        """The experts the router scores: all of them, held here or not."""
        return self.n_routed_experts or self.num_experts

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        from ..models import model as _m  # lazy; avoids an import cycle

        return _m.count_params(self)

    def active_param_count(self) -> int:
        from ..models import model as _m

        return _m.count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
