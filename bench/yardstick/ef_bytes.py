"""The least HBM traffic of one step's error-feedback pass: every element
of every bucket reads its gradient and its residual (8 B) and writes its
new residual (4 B); an element of an exchanged bucket also writes what is
sent (4 B).  A kernel that writes zero sends for the other buckets moves
more than this, so its share of the bound cannot pass 100%."""
from __future__ import annotations

import math

from .. import reference
from ..reference.covap import exchanged, plan_buckets

SELECTED_BYTES = 16
UNSELECTED_BYTES = 12


def ef_bytes(buckets, shapes, step: int, interval: int) -> int:
    """``buckets``: :func:`bench.reference.covap.plan_buckets`'s, over leaves
    of ``shapes``; the bytes of step ``step``'s pass."""
    total = 0
    for b, segs in enumerate(buckets):
        per = SELECTED_BYTES if exchanged(b, step, interval) else UNSELECTED_BYTES
        total += per * sum(s.numel(shapes[s.leaf]) for s in segs)
    return total


def plan_of(conf: dict, traffic: dict):
    """The bucket plan of a configuration under a traffic mix, with the
    leaf shapes (its reference module's) it covers: ``(buckets, shapes)``."""
    ref = reference.of(conf)
    shapes = list(ref.param_shapes(ref.Arch.from_config(conf)).values())
    buckets = plan_buckets(shapes, bucket_bytes=traffic["bucket_bytes"],
                           max_buckets=traffic["max_buckets"],
                           interval=traffic["interval"])
    assert sum(math.prod(s) for s in shapes) == sum(
        seg.numel(shapes[seg.leaf]) for segs in buckets for seg in segs)
    return buckets, shapes
