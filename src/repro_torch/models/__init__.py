"""The decoder families in PyTorch: dense, MoE, SSM (xlstm) and hybrid (zamba2)."""
from ..configs.base import InputShape
from .model import (
    DecoderLM,
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
    "InputShape",
    "build_model",
    "build_param_specs",
    "count_params",
    "long_context_variant",
    "model_flops",
    "padded_vocab",
    "param_shapes",
]
