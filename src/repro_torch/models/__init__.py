"""The model families in PyTorch: dense, MoE, SSM (xlstm), hybrid (zamba2),
VLM (pixtral) and the encoder-decoder audio family (seamless)."""
from ..configs.base import InputShape
from .model import (
    DecoderLM,
    EncDecLM,
    build_model,
    build_param_specs,
    count_params,
    long_context_variant,
    model_flops,
    padded_vocab,
    param_shapes,
)

__all__ = [
    "DecoderLM",
    "EncDecLM",
    "InputShape",
    "build_model",
    "build_param_specs",
    "count_params",
    "long_context_variant",
    "model_flops",
    "padded_vocab",
    "param_shapes",
]
