"""GC scheme registry: COVAP and the ``none``/``fp16`` baselines."""
from .base import Compressor, SyncStats, dense_bytes, get_compressor, register
from .covap import COVAP
from .simple import HalfPrecision, NoCompression

__all__ = [
    "Compressor",
    "SyncStats",
    "dense_bytes",
    "get_compressor",
    "register",
    "COVAP",
    "HalfPrecision",
    "NoCompression",
]
