"""GC scheme registry: COVAP, the ``none``/``fp16`` baselines, the
block-scaled FP8 wire, EFsignSGD, PowerSGD, and the sparsifiers Top-k, DGC,
Random-k and Ok-topk."""
from .base import (
    Compressor,
    SyncStats,
    available,
    dense_bytes,
    get_compressor,
    register,
)
from .covap import COVAP
from .fp8wire import FP8Wire
from .oktopk import OkTopK
from .powersgd import PowerSGD
from .signsgd import EFSignSGD
from .simple import HalfPrecision, NoCompression
from .sparsify import DGC, RandomK, TopK

__all__ = [
    "Compressor",
    "SyncStats",
    "available",
    "dense_bytes",
    "get_compressor",
    "register",
    "COVAP",
    "DGC",
    "EFSignSGD",
    "FP8Wire",
    "HalfPrecision",
    "NoCompression",
    "OkTopK",
    "PowerSGD",
    "RandomK",
    "TopK",
]
