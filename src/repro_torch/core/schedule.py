"""Static communication schedules: the *plan* half of the plan/execute split
(the all-reduce case of ``repro.core.schedule``).

Bucket selection is a static function of ``(phase, interval)``, so each
phase's ``CommSchedule`` records which buckets are communicated, with which
collective, at which wire dtype, and exactly how many bytes each worker
injects, before any step runs.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .bucketing import BucketPlan, Segment


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One planned collective: what a single bucket puts on the wire during
    this phase.  ``payload_bytes`` counts the bytes one worker injects once;
    ring amplification is applied by :meth:`wire_bytes`."""

    target: str                # "bucket:3"
    op: str                    # "all_reduce"
    wire_dtype: str            # dtype name of the wire payload
    payload_bytes: int
    index_bytes: int = 0

    @property
    def bytes_per_worker(self) -> int:
        return self.payload_bytes + self.index_bytes

    def wire_bytes(self, world: int) -> float:
        """Bytes one worker moves under the ring all-reduce: ``2(W-1)/W`` of
        the buffer."""
        if self.op != "all_reduce":
            raise NotImplementedError(f"op {self.op!r} is not ported")
        if world <= 1:
            return 0.0
        return 2.0 * (world - 1) / world * float(self.bytes_per_worker)


@dataclasses.dataclass(frozen=True)
class CommSchedule:
    """Per-phase static communication plan of one compressor: ``selected``
    bucket indices aligned 1:1 with ``calls``; the originating
    :class:`BucketPlan` rides along so ``execute`` can slice segments."""

    compressor: str
    phase: int
    num_phases: int
    granularity: str                     # "bucket"
    selected: tuple[int, ...]
    calls: tuple[CollectiveCall, ...]
    dense_bytes: int
    world: int = 1
    plan: BucketPlan | None = None
    sync: str = "allreduce"

    @property
    def bytes_per_worker(self) -> int:
        """Exact bytes each worker injects inside ``execute`` this phase."""
        return sum(c.bytes_per_worker for c in self.calls)

    @property
    def volume_ratio(self) -> float:
        return self.dense_bytes / max(self.bytes_per_worker, 1)

    def wire_bytes(self, world: int | None = None) -> float:
        w = self.world if world is None else world
        return sum(c.wire_bytes(w) for c in self.calls)

    def segments(self, index: int) -> tuple[Segment, ...]:
        """Segments of selected entry ``index``."""
        if self.plan is None:
            raise ValueError("schedule has no bucket-plan segments")
        return self.plan.buckets[self.selected[index]].segments

    def summary(self) -> dict:
        ops: dict[str, int] = {}
        for c in self.calls:
            ops[c.op] = ops.get(c.op, 0) + c.bytes_per_worker
        return {
            "compressor": self.compressor,
            "phase": self.phase,
            "num_phases": self.num_phases,
            "granularity": self.granularity,
            "selected": list(self.selected),
            "num_calls": len(self.calls),
            "bytes_per_worker": self.bytes_per_worker,
            "dense_bytes": self.dense_bytes,
            "volume_ratio": round(self.volume_ratio, 3),
            "bytes_by_op": ops,
            "sync": self.sync,
        }


def mean_bytes_per_step(schedules: Sequence[CommSchedule]) -> float:
    schedules = tuple(schedules)
    if not schedules:
        return 0.0
    return sum(s.bytes_per_worker for s in schedules) / len(schedules)
