"""Baseline compressors: no-compression DDP and a half-precision wire.

``none``  per-bucket dense all-reduce (the paper's DDP baseline):
          ``SyncPipeline(wire=WireCast(None))``.
``fp16``  cast to a half type on the wire, all-reduce, cast back (Table II
          row FP16): ``SyncPipeline(wire=WireCast('bfloat16'))``; the wire
          type is selectable (``wire_dtype='float16'``).

Neither has an EF stage, so neither runs a kernel: the arena pack is a
copy (and cast) of the gradient into its slot.
"""
from __future__ import annotations

from ..stages import SyncPipeline, WireCast
from .base import register


@register("none")
class NoCompression(SyncPipeline):
    def __init__(self, **opts):
        super().__init__(wire=WireCast(None), **opts)


@register("fp16")
class HalfPrecision(SyncPipeline):
    def __init__(self, wire_dtype: str = "bfloat16", **opts):
        super().__init__(wire=WireCast(wire_dtype), **opts)
