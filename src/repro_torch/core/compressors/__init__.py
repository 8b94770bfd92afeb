"""GC scheme registry.  Only COVAP is ported so far."""
from .base import Compressor, SyncStats, dense_bytes, get_compressor, register
from .covap import COVAP

__all__ = [
    "Compressor",
    "SyncStats",
    "dense_bytes",
    "get_compressor",
    "register",
    "COVAP",
]
