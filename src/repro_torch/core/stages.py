"""Gradient-sync stages + the ``SyncPipeline`` combinator: the segmented
all-reduce path of ``repro.core.stages``, which COVAP runs::

    SyncPipeline(filter=CoarseFilter(I), ef=ErrorFeedback(EFSchedule(...)),
                 wire=WireCast())

``plan_phase`` emits a static :class:`CommSchedule`; ``execute`` walks the
plan bucket by bucket, runs error feedback on every bucket (the fused
``ef_update`` kernel on CUDA), and all-reduces the selected buckets one
segment at a time.  Ported so far: the dense ``WireCast`` without a wire
cast, and the non-arena, ``sync="allreduce"`` form; other options raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from . import bucketing as bk
from .bucketing import Bucket, BucketPlan
from .comm import Compressor, SyncStats, dense_bytes, pmean
from .error_feedback import EFSchedule, init_residual
from .filter import selected_buckets
from .schedule import CollectiveCall, CommSchedule


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def bucket_dtype(plan: BucketPlan, bucket: Bucket) -> torch.dtype:
    """Dtype of the flattened bucket (mixed buckets promote)."""
    dt = plan.leaf_dtypes[bucket.segments[0].leaf_idx]
    for s in bucket.segments[1:]:
        dt = torch.promote_types(dt, plan.leaf_dtypes[s.leaf_idx])
    return dt


@dataclasses.dataclass(frozen=True)
class CoarseFilter:
    """The paper's coarse-grained filter (SS III.A): bucket ``b`` is
    communicated in phase ``p`` iff ``(b + p) % interval == 0``."""

    interval: int = 4

    def num_phases(self) -> int:
        return max(int(self.interval), 1)

    def select(self, plan: BucketPlan, phase: int) -> tuple[int, ...]:
        return selected_buckets(plan.num_buckets, phase, self.interval)


@dataclasses.dataclass(frozen=True)
class ErrorFeedback:
    """Compensation + residual stage (SS III.D) with COVAP's ascending
    :class:`EFSchedule`."""

    schedule: EFSchedule = EFSchedule()


class WireCast:
    """Dense segment-wise all-reduce.  The reference's optional wire cast
    (``WireCast('bfloat16')``) is not ported."""

    def __init__(self, wire_dtype: str | None = None):
        if wire_dtype:
            raise NotImplementedError(
                f"WireCast(wire_dtype={wire_dtype!r}) is not ported; only the "
                "dense wire (no cast) is"
            )

    def plan_bucket(self, plan: BucketPlan, bucket: Bucket, world: int = 1
                    ) -> CollectiveCall:
        return CollectiveCall(
            f"bucket:{bucket.index}", "all_reduce",
            _dtype_name(bucket_dtype(plan, bucket)), bucket.nbytes,
        )

    def execute_segment(self, x: torch.Tensor, group):
        """-> (synced_segment, residual_segment)."""
        return pmean(x, group), torch.zeros_like(x)

    def __repr__(self):
        return "WireCast(None)"


def _state_present(state: Any) -> bool:
    return state is not None and not (isinstance(state, (tuple, list)) and len(state) == 0)


class SyncPipeline(Compressor):
    """filter ∘ error-feedback ∘ wire, with the plan/execute split."""

    name = "pipeline"

    def __init__(self, *, wire: WireCast, filter: CoarseFilter | None = None,
                 ef: ErrorFeedback | None = None, **opts):
        for key in ("use_arena", "use_pack_kernel"):
            if opts.get(key):
                raise NotImplementedError(f"{key}=True is not ported")
        sync = opts.get("sync", "allreduce") or "allreduce"
        if sync != "allreduce":
            raise NotImplementedError(
                f"sync={sync!r} is not ported; only 'allreduce' is"
            )
        super().__init__(**opts)
        self.wire = wire
        self.filter = filter
        self.ef = ef

    @property
    def stages(self) -> tuple:
        return tuple(s for s in (self.filter, self.ef, self.wire) if s is not None)

    def __repr__(self):
        inner = " ∘ ".join(repr(s) for s in self.stages)
        return f"{type(self).__name__}[{inner}]"

    # ---- lifecycle --------------------------------------------------------
    def num_phases(self) -> int:
        return self.filter.num_phases() if self.filter is not None else 1

    def init_state(self, params: list[torch.Tensor], plan: BucketPlan) -> Any:
        if self.ef is None:
            return ()
        return init_residual(params)

    # ---- plan -------------------------------------------------------------
    def plan_phase(self, plan: BucketPlan, phase: int, *, world: int = 1
                   ) -> CommSchedule:
        n = self.num_phases()
        ph = int(phase) % max(n, 1)
        sel = (
            self.filter.select(plan, ph) if self.filter is not None
            else tuple(range(plan.num_buckets))
        )
        calls = tuple(self.wire.plan_bucket(plan, plan.buckets[b], world) for b in sel)
        return CommSchedule(
            compressor=self.name,
            phase=ph,
            num_phases=max(n, 1),
            granularity="bucket",
            selected=tuple(sel),
            calls=calls,
            dense_bytes=dense_bytes(plan),
            world=world,
            plan=plan,
        )

    # ---- execute ----------------------------------------------------------
    def execute(self, schedule: CommSchedule, grads: list[torch.Tensor],
                state: Any, *, step: int = 0, group=None):
        """-> (synced leaves, new state, stats).  ``grads`` and the residuals
        in ``state`` are lists of tensors in leaf order; neither is
        modified."""
        stats = SyncStats(schedule.bytes_per_worker, schedule.dense_bytes)
        out, new_state = self._execute_segmented(schedule, grads, state, step, group)
        return out, new_state, stats

    def ef_coefficient(self, step: int) -> float | None:
        """The EF coefficient of ``step``; ``None`` without an EF stage."""
        if self.ef is None:
            return None
        return self.ef.schedule.coefficient(step)

    def _use_ef_kernel(self, g: torch.Tensor, r, coeff) -> bool:
        """The fused EF kernel (``kernels.ef_covap.ef_update``) replaces the
        two-op form on the segmented path: one pass computes
        ``t = g + c*r`` and splits it into ``(send, r')``.  Applies to f32
        operands with EF on (the dense wire has no cast).

        Engagement: on CUDA tensors by default; ``use_ef_kernel=False`` keeps
        the two-op form; on CPU tensors the two-op form runs, and an
        explicit ``use_ef_kernel=True`` raises, since the kernel needs the
        GPU."""
        if not (coeff is not None and r is not None
                and g.dtype == torch.float32 and r.dtype == torch.float32):
            return False
        use = self.options.get("use_ef_kernel")
        if use is None:
            return g.is_cuda
        if use and not g.is_cuda:
            raise ValueError(
                "use_ef_kernel=True needs CUDA tensors; the gradients are on "
                f"{g.device}"
            )
        return bool(use)

    def _ef_segment(self, g, r, coeff, *, selected: bool, group):
        """One segment through EF ∘ filter-decision ∘ wire.  Returns
        ``(synced, resid)``: the synced value (``None`` for an unselected
        bucket) and the new residual (``None`` when EF is off)."""
        if self._use_ef_kernel(g, r, coeff):
            from ..kernels.ef_covap import ef_update

            send, rnew = ef_update(
                g.reshape(-1), r.reshape(-1), coeff, selected=selected
            )
            rnew = rnew.view(g.shape)
            if not selected:
                return None, rnew
            return pmean(send.view(g.shape), group), rnew
        if r is None:
            t = g.clone() if selected else g
        else:
            t = g + coeff * r.to(g.dtype)
        if not selected:
            return None, (t if r is not None else None)
        xm, resid = self.wire.execute_segment(t, group)
        return xm, (resid if r is not None else None)

    def execute_bucket(self, schedule: CommSchedule, b: int,
                       g_slices: Sequence[torch.Tensor],
                       r_slices: Sequence[torch.Tensor] | None = None, *,
                       coeff=None, group=None):
        """Synchronise ONE bucket: ``g_slices``/``r_slices`` are its
        segments' gradient and residual slices.  Returns
        ``(synced_slices, resid_slices)``; ``synced_slices`` is ``None`` for
        an unselected bucket, ``resid_slices`` is ``None`` without EF."""
        selected = b in schedule.selected
        synced, resids = [], []
        rs = r_slices if r_slices is not None else (None,) * len(g_slices)
        for g, r in zip(g_slices, rs):
            xm, rr = self._ef_segment(g, r, coeff, selected=selected, group=group)
            synced.append(xm)
            resids.append(rr)
        return (
            synced if selected else None,
            resids if r_slices is not None else None,
        )

    @torch.no_grad()
    def _execute_segmented(self, schedule, grads, state, step, group):
        """Per-segment slices of every bucket.  With EF on, every bucket
        (selected or not) goes through :meth:`execute_bucket`, so the
        residual update fuses with the compensation."""
        plan = schedule.plan
        ef_on = self.ef is not None and _state_present(state)
        coeff = self.ef_coefficient(step) if ef_on else None
        out = [torch.zeros_like(g) for g in grads]
        resid = [torch.zeros_like(g) for g in grads] if ef_on else None

        todo = range(plan.num_buckets) if ef_on else dict.fromkeys(schedule.selected)
        for b in todo:
            segs = plan.buckets[b].segments
            g_slices = [bk._slice_segment(grads[s.leaf_idx], s) for s in segs]
            r_slices = (
                [bk._slice_segment(state[s.leaf_idx], s) for s in segs]
                if ef_on else None
            )
            synced, resids = self.execute_bucket(
                schedule, b, g_slices, r_slices, coeff=coeff, group=group,
            )
            if synced is not None:
                for seg, xm in zip(segs, synced):
                    bk._update_segment(out[seg.leaf_idx], seg, xm)
            if resids is not None:
                for seg, rr in zip(segs, resids):
                    bk._update_segment(resid[seg.leaf_idx], seg, rr)
        return out, (resid if ef_on else state)
