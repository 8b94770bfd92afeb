"""Compressor interface + registry, re-exported from ``repro_torch.core.comm``
(the reference keeps the same import surface)."""
from __future__ import annotations

from ..comm import (  # noqa: F401
    Compressor,
    SyncStats,
    available,
    dense_bytes,
    get_compressor,
    pmean,
    register,
    world_size,
)

__all__ = [
    "Compressor",
    "available",
    "SyncStats",
    "dense_bytes",
    "get_compressor",
    "pmean",
    "register",
    "world_size",
]
