"""Kernels written by hand for Hopper, each beside its plain PyTorch version
in ``ref.py`` (AdamW's beside ``optim.adamw``'s ``update`` and
``apply_updates``); ``ops.py`` is the counterpart of ``repro.kernels.ops``.
CUDA sources live in ``csrc/`` and are built at first use (``_build.py``;
the causal attention's plain path is ``models.attention._attend_plain``, the
MoE dispatch's ``models.moe``'s);
nothing is compiled at import time."""
# under other names, so that ``repro_torch.kernels.adamw_fused``,
# ``repro_torch.kernels.causal_attn`` and ``repro_torch.kernels.moe_dispatch``
# stay the modules
from .adamw_fused import adamw_fused as _adamw_fused
from .causal_attn import causal_attn as _causal_attn
from .moe_dispatch import moe_dispatch as _moe_dispatch
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



def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launches in this process, by name (the matmul
    as ``"lowrank.matmul"``)."""
    fns = {f.__name__: f for f in (ef_update, pack_ef_cast, quantize_fp8,
                                   dequantize_fp8, sign_compress, threshold_filter,
                                   _adamw_fused, _causal_attn, _moe_dispatch)}
    fns["lowrank.matmul"] = matmul
    return {name: int(f.launches) for name, f in fns.items()}


__all__ = [
    "dequantize_fp8",
    "dequantize_fp8_ref",
    "ef_update",
    "ef_update_cuda",
    "ef_update_ref",
    "launch_counts",
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
