"""GC scheme registry: COVAP, the ``none``/``fp16`` baselines, the
block-scaled FP8 wire, EFsignSGD and PowerSGD."""
from .base import Compressor, SyncStats, dense_bytes, get_compressor, register
from .covap import COVAP
from .fp8wire import FP8Wire
from .powersgd import PowerSGD
from .signsgd import EFSignSGD
from .simple import HalfPrecision, NoCompression

__all__ = [
    "Compressor",
    "SyncStats",
    "dense_bytes",
    "get_compressor",
    "register",
    "COVAP",
    "EFSignSGD",
    "FP8Wire",
    "HalfPrecision",
    "NoCompression",
    "PowerSGD",
]
