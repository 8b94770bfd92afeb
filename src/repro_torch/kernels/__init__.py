"""Kernels written by hand for Hopper, each beside its plain PyTorch version
in ``ref.py``.  CUDA sources live in ``csrc/`` and are built at first use
(``_build.py``); nothing is compiled at import time."""
from .ef_covap import ef_update, ef_update_cuda
from .pack_ef_cast import pack_ef_cast, pack_ef_cast_into
from .ref import ef_update_ref, pack_ef_cast_ref

__all__ = [
    "ef_update",
    "ef_update_cuda",
    "ef_update_ref",
    "pack_ef_cast",
    "pack_ef_cast_into",
    "pack_ef_cast_ref",
]
