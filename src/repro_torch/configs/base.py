"""Architecture config schema: the fields the dense decoder reads, with the
same defaults as ``repro.configs.base.ArchConfig``, and the named input
shapes (``INPUT_SHAPES``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # only "dense" is ported
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    rope_theta: float = 10000.0
    # carried for ``models.long_context_variant``; the port's attention is
    # full, so ``build_model`` refuses a config with a window
    sliding_window: int = 0          # 0 = full attention
    # carried for parity with the reference config; like the reference
    # decoder, the port keeps an untied ``head.w`` and never reads it
    tie_embeddings: bool = True

    mlp_act: str = "swiglu"          # swiglu | geglu | gelu
    norm_eps: float = 1e-6

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    xent_chunk: int = 512            # sequence chunk for the softmax-xent loss
    attn_chunk: int = 256            # q-chunk for the streaming attention

    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


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
