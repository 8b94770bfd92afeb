"""Public wrappers of the port's kernels, the counterpart of
``repro.kernels.ops``: the same names, each the CUDA kernel on CUDA tensors
and its plain PyTorch version on CPU tensors, plus ``pack_ef_cast``, which
the reference exposes from its own module."""
from .ef_covap import ef_update
from .lowrank import matmul
from .pack_ef_cast import pack_ef_cast
from .quantize import dequantize_fp8, quantize_fp8
from .ref import sign_decompress
from .sign_compress import sign_compress
from .topk_threshold import sample_threshold, threshold_filter

__all__ = [
    "ef_update",
    "matmul",
    "pack_ef_cast",
    "quantize_fp8",
    "dequantize_fp8",
    "sign_compress",
    "sign_decompress",
    "threshold_filter",
    "sample_threshold",
]
