"""Kernels written by hand for Hopper, each beside its plain PyTorch version
in ``ref.py``; ``ops.py`` is the counterpart of ``repro.kernels.ops``.  CUDA
sources live in ``csrc/`` and are built at first use (``_build.py``);
nothing is compiled at import time."""
from .ef_covap import ef_update, ef_update_cuda
from .lowrank import matmul
from .pack_ef_cast import pack_ef_cast, pack_ef_cast_into
from .quantize import dequantize_fp8, quantize_fp8
from .ref import (
    dequantize_fp8_ref,
    ef_update_ref,
    matmul_ref,
    pack_ef_cast_ref,
    quantize_fp8_ref,
    sign_compress_partials_ref,
    sign_compress_ref,
    sign_decompress,
    threshold_filter_ref,
)
from .sign_compress import sign_compress, sign_compress_partials
from .topk_threshold import sample_threshold, threshold_filter

__all__ = [
    "dequantize_fp8",
    "dequantize_fp8_ref",
    "ef_update",
    "ef_update_cuda",
    "ef_update_ref",
    "matmul",
    "matmul_ref",
    "pack_ef_cast",
    "pack_ef_cast_into",
    "pack_ef_cast_ref",
    "quantize_fp8",
    "quantize_fp8_ref",
    "sample_threshold",
    "sign_compress",
    "sign_compress_partials",
    "sign_compress_partials_ref",
    "sign_compress_ref",
    "sign_decompress",
    "threshold_filter",
    "threshold_filter_ref",
]
