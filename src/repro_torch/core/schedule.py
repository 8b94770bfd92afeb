"""Static communication schedules: the *plan* half of the plan/execute split
(``repro.core.schedule`` without the per-link split of hierarchical pods).

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

    target: str                # "bucket:3" | "param-bucket:3"
    op: str                    # "all_reduce" | "reduce_scatter" | "all_gather" | "all_to_all"
    wire_dtype: str            # dtype name of the wire payload
    payload_bytes: int
    index_bytes: int = 0
    # planned in this phase but issued at the head of the next step, where
    # it overlaps the forward pass (sharded sync's param all-gather)
    deferred: bool = False

    @property
    def bytes_per_worker(self) -> int:
        return self.payload_bytes + self.index_bytes

    def wire_bytes(self, world: int) -> float:
        """Bytes one worker moves under the ring algorithms: an all-reduce
        moves ``2(W-1)/W`` of the buffer, a reduce-scatter ``(W-1)/W`` of the
        buffer it feeds in, an all-gather re-sends its local shard ``W-1``
        times, an all-to-all keeps ``1/W`` of its buffer local.  A
        reduce-scatter's ``payload_bytes`` is the full input buffer, an
        all-gather's the local shard, an all-to-all's the buffer it
        sends."""
        if world <= 1:
            return 0.0
        b = float(self.bytes_per_worker)
        if self.op == "all_reduce":
            return 2.0 * (world - 1) / world * b
        if self.op == "reduce_scatter":
            return (world - 1) / world * b
        if self.op == "all_gather":
            return (world - 1) * b
        if self.op == "all_to_all":
            return (world - 1) / world * b
        raise ValueError(f"unknown collective op {self.op!r}")


@dataclasses.dataclass(frozen=True)
class CommSchedule:
    """Per-phase static communication plan of one compressor: ``selected``
    bucket indices aligned 1:1 with ``calls`` (a bucket that a wire stage
    plans several collectives for repeats its index); the originating
    :class:`BucketPlan` rides along so ``execute`` can slice segments."""

    compressor: str
    phase: int
    num_phases: int
    granularity: str                     # "bucket" | "leaf"
    selected: tuple[int, ...]
    calls: tuple[CollectiveCall, ...]
    dense_bytes: int
    world: int = 1
    plan: BucketPlan | None = None
    # each call's issue rank in the backward pass (``ReadyOrder``): rank 0
    # is the first collective whose gradients land; empty on the leaf path
    ready_ranks: tuple[int, ...] = ()
    # "allreduce" (one all-reduce per selected bucket) or "sharded" (a
    # reduce-scatter per selected bucket, the optimizer on the local shard,
    # and the param all-gathers of ``deferred_calls`` at the next step's
    # head)
    sync: str = "allreduce"
    deferred_calls: tuple[CollectiveCall, ...] = ()

    @property
    def bytes_per_worker(self) -> int:
        """Exact bytes each worker injects inside ``execute`` this phase
        (``deferred_calls`` excluded)."""
        return sum(c.bytes_per_worker for c in self.calls)

    @property
    def exposed_bytes_per_worker(self) -> int:
        """Bytes whose collective must finish before the optimizer steps."""
        return self.bytes_per_worker

    @property
    def deferred_bytes_per_worker(self) -> int:
        """Bytes of the deferred param all-gathers (sharded sync)."""
        return sum(c.bytes_per_worker for c in self.deferred_calls)

    @property
    def total_bytes_per_worker(self) -> int:
        return self.bytes_per_worker + self.deferred_bytes_per_worker

    def exposed_wire_bytes(self, world: int | None = None) -> float:
        """Ring-amplified wire bytes of the exposed calls only."""
        w = self.world if world is None else world
        return sum(c.wire_bytes(w) for c in self.calls)

    def deferred_wire_bytes(self, world: int | None = None) -> float:
        w = self.world if world is None else world
        return sum(c.wire_bytes(w) for c in self.deferred_calls)

    @property
    def volume_ratio(self) -> float:
        return self.dense_bytes / max(self.bytes_per_worker, 1)

    def wire_bytes(self, world: int | None = None) -> float:
        w = self.world if world is None else world
        return sum(c.wire_bytes(w) for c in self.calls)

    def issue_order(self) -> tuple[int, ...]:
        """Indices into ``calls`` in backward readiness order, the order the
        fused overlap issues this phase's collectives; plan order without
        ranks."""
        if len(self.ready_ranks) != len(self.calls):
            return tuple(range(len(self.calls)))
        return tuple(sorted(range(len(self.calls)), key=lambda i: self.ready_ranks[i]))

    def segments(self, index: int) -> tuple[Segment, ...]:
        """Segments of selected entry ``index``."""
        if self.plan is None:
            raise ValueError("schedule has no bucket-plan segments")
        return self.plan.buckets[self.selected[index]].segments

    def summary(self) -> dict:
        ops: dict[str, int] = {}
        for c in self.calls:
            ops[c.op] = ops.get(c.op, 0) + c.bytes_per_worker
        out = {
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
        if self.sync != "allreduce":
            out["exposed_bytes_per_worker"] = self.exposed_bytes_per_worker
            out["deferred_bytes_per_worker"] = self.deferred_bytes_per_worker
            out["total_bytes_per_worker"] = self.total_bytes_per_worker
        return out


def plan_all_phases(compressor, plan: BucketPlan, *, world: int = 1
                    ) -> tuple[CommSchedule, ...]:
    """Every phase's schedule: one training cycle's static comm plan."""
    n = max(compressor.num_phases(), 1)
    return tuple(compressor.plan_phase(plan, p, world=world) for p in range(n))


def mean_bytes_per_step(schedules: Sequence[CommSchedule]) -> float:
    schedules = tuple(schedules)
    if not schedules:
        return 0.0
    return sum(s.bytes_per_worker for s in schedules) / len(schedules)
