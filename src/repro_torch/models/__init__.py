"""The dense decoder family in PyTorch (gpt2-paper)."""
from .model import (
    DecoderLM,
    build_model,
    count_params,
    padded_vocab,
    param_shapes,
)

__all__ = [
    "DecoderLM",
    "build_model",
    "count_params",
    "padded_vocab",
    "param_shapes",
]
