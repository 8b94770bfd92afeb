"""COVAP coarse-grained gradient filter (paper SS III.A).

Bucket ``t`` is communicated at iteration ``num_steps`` iff
``(t + num_steps) % I == 0``: every bucket is communicated exactly once per
``I`` consecutive iterations, and every worker derives the same selection
from ``(step, I)`` locally, with no index exchange.  The trainer builds one
step function per ``phase = step % I``.
"""
from __future__ import annotations

from .bucketing import BucketPlan


def is_selected(bucket_idx: int, step: int, interval: int) -> bool:
    """The paper's selection rule, verbatim."""
    if interval <= 1:
        return True
    return (bucket_idx + step) % interval == 0


def selected_buckets(num_buckets: int, phase: int, interval: int) -> tuple[int, ...]:
    """Indices of buckets communicated at any step with ``step % I == phase``."""
    if interval <= 1:
        return tuple(range(num_buckets))
    return tuple(b for b in range(num_buckets) if (b + phase) % interval == 0)


def selected_numel(plan: BucketPlan, phase: int, interval: int) -> int:
    sel = selected_buckets(plan.num_buckets, phase, interval)
    return sum(plan.buckets[b].numel for b in sel)


def compression_ratio(plan: BucketPlan, interval: int) -> float:
    """Average achieved volume-compression ratio over one full period."""
    if interval <= 1:
        return 1.0
    per_step = [selected_numel(plan, p, interval) for p in range(interval)]
    return plan.total_numel() / max(sum(per_step) / interval, 1)


def schedule_table(num_buckets: int, interval: int, steps: int) -> list[list[int]]:
    """The bucket selection of each of ``steps`` iterations."""
    return [[b for b in range(num_buckets) if is_selected(b, s, interval)]
            for s in range(steps)]
