"""Gradient-sync stages + the ``SyncPipeline`` combinator: the segmented
path of ``repro.core.stages``, which COVAP and the ``none``/``fp16``
baselines run, and its flat-bucket path, which the block-scaled FP8 wire
(``fp8wire``) and EFsignSGD (``efsignsgd``) run::

    SyncPipeline(filter=CoarseFilter(I), ef=ErrorFeedback(EFSchedule(...)),
                 wire=WireCast())
    SyncPipeline(ef=ErrorFeedback(), wire=FP8Block(8192))

``plan_phase`` emits a static :class:`CommSchedule`; ``execute`` walks the
plan bucket by bucket.  A segmented wire (``WireCast``) has three execution
forms, as in the reference:

* the per-segment form (default): EF on every bucket (the ``ef_update``
  kernel on CUDA without a wire cast), one all-reduce per selected segment;
* the zero-copy arena (``use_arena=True``): one pack pass writes every
  selected segment's compensated, wire-cast values straight into its slot
  of a flat plane (the ``pack_ef_cast`` kernel on CUDA), one collective per
  bucket runs in place on the slot view, and static slices carry the
  results back to the leaves;
* sharded sync (``sync="sharded"``): each selected bucket's W-aligned slot
  is reduce-scattered instead of all-reduced; the worker keeps the mean on
  the shard it owns and zeros elsewhere, and the trainer all-gathers the
  updated params at the next step's head (``core.overlap``).

A flat wire (``FP8Block``, ``SignCompress``) sees each selected bucket as
one flat vector: classic EF compensates the whole tree (``t = g + r``), each
selected bucket's compensated slices are concatenated, the wire stage
encodes, all-gathers and decodes them, and the residual is ``t - sent``,
where ``sent`` is this worker's own decoded contribution.  With
``use_arena=True`` the compensated tree is packed once into flat planes and
each wire stage runs on its bucket's slot view.  On CUDA tensors the wire
stages run the ``quantize_fp8`` / ``dequantize_fp8`` and ``sign_compress``
kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from . import arena as ar
from . import bucketing as bk
from .arena import bucket_dtype
from .bucketing import Bucket, BucketPlan
from .comm import (
    Compressor,
    SyncStats,
    all_gather,
    dense_bytes,
    flat_axis_index,
    pmean,
    reduce_scatter,
    world_size,
)
from .error_feedback import EFSchedule, init_residual
from .filter import selected_buckets
from .schedule import CollectiveCall, CommSchedule
from ..kernels.ref import (
    FP8_BLOCK,
    dequantize_fp8_ref,
    pack_ef_cast_ref,
    quantize_fp8_ref,
    sign_compress_ref,
    wire_torch_dtype,
)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


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
    """Compensation + residual stage (SS III.D).  ``schedule=None`` is the
    classic EF of the baselines (coefficient 1); COVAP passes its ascending
    :class:`EFSchedule`."""

    schedule: EFSchedule | None = None

    def compensated(self, grads: Sequence[torch.Tensor],
                    residual: Sequence[torch.Tensor], step: int
                    ) -> list[torch.Tensor]:
        """``t = g + r`` (classic EF, no multiply) or ``t = g + c*r`` with
        the schedule's coefficient of ``step``, leaf by leaf."""
        if self.schedule is None:
            return [g + r.to(g.dtype) for g, r in zip(grads, residual)]
        c = self.schedule.coefficient(step)
        return [g + c * r.to(g.dtype) for g, r in zip(grads, residual)]


class WireStage:
    """How one selected bucket crosses the network.

    ``plan_bucket`` is the static half (exact per-worker bytes, collective
    op, wire dtype); ``execute_bucket`` / ``execute_segment`` the executed
    half.  ``segmented=True`` stages work on segment slices; the rest see
    the flat bucket vector."""

    segmented: bool = False

    def plan_bucket(self, plan: BucketPlan, bucket: Bucket, world: int = 1
                    ) -> CollectiveCall:
        raise NotImplementedError

    def execute_bucket(self, flat: torch.Tensor, key, group, *,
                       use_kernel: bool = False):
        """-> ``(synced_flat, local_sent_flat)``.  ``key`` is the PRNG key of
        Random-k, which is not ported (always ``None``); ``use_kernel``
        runs the stage's CUDA kernels instead of their plain versions."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class WireCast(WireStage):
    """Dense segment-wise all-reduce, optionally cast on the wire.

    ``WireCast(None)`` is the DDP baseline; ``WireCast('bfloat16')`` halves
    the wire volume, and with an :class:`ErrorFeedback` stage the cast's
    error lands in the EF residual."""

    segmented = True

    def __init__(self, wire_dtype: str | torch.dtype | None = None):
        self.wire_dtype = wire_torch_dtype(wire_dtype)

    def plan_bucket(self, plan: BucketPlan, bucket: Bucket, world: int = 1
                    ) -> CollectiveCall:
        if self.wire_dtype is not None:
            payload = bucket.numel * _itemsize(self.wire_dtype)
            name = _dtype_name(self.wire_dtype)
        else:
            payload = bucket.nbytes
            name = _dtype_name(bucket_dtype(plan, bucket))
        return CollectiveCall(f"bucket:{bucket.index}", "all_reduce", name, payload)

    def execute_segment(self, x: torch.Tensor, group):
        """-> (synced_segment, residual_segment).  ``x`` is a fresh tensor
        that the all-reduce may overwrite."""
        if self.wire_dtype is not None and x.dtype != self.wire_dtype:
            xw = x.to(self.wire_dtype)
            resid = x - xw.to(x.dtype)       # before the in-place reduce
            return pmean(xw, group).to(x.dtype), resid
        return pmean(x, group), torch.zeros_like(x)

    def __repr__(self):
        return f"WireCast({_dtype_name(self.wire_dtype) if self.wire_dtype else None})"


class SignCompress(WireStage):
    """EFsignSGD wire format: int8 signs (1 byte an element) and one float32
    scale ``mean(|t|)``, exchanged by all-gather (each worker's signs
    differ) and decoded as ``mean_w(scale_w * sign_w)``."""

    def plan_bucket(self, plan, bucket, world=1):
        return CollectiveCall(f"bucket:{bucket.index}", "all_gather", "int8",
                              bucket.numel * 1, 4)

    def execute_bucket(self, flat, key, group, *, use_kernel=False):
        if use_kernel:
            from ..kernels.sign_compress import sign_compress

            signs, scale = sign_compress(flat.float())
        else:
            signs, scale = sign_compress_ref(flat)
        scale = scale.to(flat.dtype)
        signs_all = all_gather(signs, group)                 # (W, n) int8
        scales_all = all_gather(scale.reshape(1), group)     # (W, 1)
        decoded = (signs_all.to(flat.dtype) * scales_all).mean(dim=0)
        local_sent = scale * signs.to(flat.dtype)
        return decoded, local_sent


class FP8Block(WireStage):
    """Block-scaled FP8 wire (4x against float32): a float8_e4m3fn payload
    and one float32 amax scale per ``block`` elements, exchanged by
    all-gather (each worker's payload differs) and decoded as the mean of
    the W dequantised contributions."""

    def __init__(self, block: int = FP8_BLOCK):
        self.block = int(block)

    def plan_bucket(self, plan, bucket, world=1):
        nb = max(1, -(-bucket.numel // self.block))
        return CollectiveCall(f"bucket:{bucket.index}", "all_gather",
                              "float8_e4m3fn", bucket.numel * 1, nb * 4)

    def _dequantize(self, q, scales, out, use_kernel):
        if use_kernel:
            from ..kernels.quantize import dequantize_fp8

            return dequantize_fp8(q, scales, self.block, out=out)
        return out.copy_(dequantize_fp8_ref(q, scales, self.block))

    def execute_bucket(self, flat, key, group, *, use_kernel=False):
        if use_kernel:
            from ..kernels.quantize import quantize_fp8

            q, scales = quantize_fp8(flat.float(), self.block)
        else:
            q, scales = quantize_fp8_ref(flat, self.block)
        q_all = all_gather(q, group)                          # (W, n) fp8
        s_all = all_gather(scales, group)                     # (W, nb)
        dec = torch.empty(q_all.shape, dtype=torch.float32, device=flat.device)
        for w in range(q_all.shape[0]):
            self._dequantize(q_all[w], s_all[w], dec[w], use_kernel)
        local_sent = self._dequantize(q, scales, torch.empty_like(dec[0]),
                                      use_kernel)
        return dec.mean(dim=0).to(flat.dtype), local_sent.to(flat.dtype)

    def __repr__(self):
        return f"FP8Block({self.block})"


def _split_like(slices: Sequence[torch.Tensor], flat: torch.Tensor
                ) -> list[torch.Tensor]:
    """Split a flat bucket vector into views shaped like ``slices``."""
    out, off = [], 0
    for x in slices:
        n = x.numel()
        out.append(flat[off:off + n].view(x.shape))
        off += n
    return out


def _state_present(state: Any) -> bool:
    return state is not None and not (isinstance(state, (tuple, list)) and len(state) == 0)


class SyncPipeline(Compressor):
    """filter ∘ error-feedback ∘ wire, with the plan/execute split.

    Options: ``use_ef_kernel``, ``use_pack_kernel`` and
    ``use_wire_kernel`` (the flat wires' kernels) (``None``: the CUDA
    kernel on CUDA tensors, the plain form on CPU tensors; ``False``: the
    plain form everywhere; ``True`` on CPU tensors raises), ``use_arena``
    and ``sync`` (``"allreduce"`` or ``"sharded"``; a flat wire takes only
    ``"allreduce"``)."""

    name = "pipeline"

    def __init__(self, *, wire: WireCast, filter: CoarseFilter | None = None,
                 ef: ErrorFeedback | None = None, **opts):
        super().__init__(**opts)
        self.wire = wire
        self.filter = filter
        self.ef = ef
        self._layouts: dict = {}
        sync = self.options.get("sync", "allreduce") or "allreduce"
        if sync not in ("allreduce", "sharded"):
            raise ValueError(f"sync must be 'allreduce' or 'sharded', got {sync!r}")
        if sync == "sharded" and not getattr(self.wire, "segmented", False):
            raise ValueError(
                "sync='sharded' requires a segmented bucket pipeline "
                f"(covap / none / fp16); {self.wire!r} must use sync='allreduce'"
            )

    @property
    def sync_mode(self) -> str:
        """``"allreduce"`` (one all-reduce per selected bucket) or
        ``"sharded"`` (reduce-scatter, then the deferred param all-gather
        at the next step's head)."""
        return self.options.get("sync", "allreduce") or "allreduce"

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
    def _plan_bucket_sharded(self, plan: BucketPlan, bucket: Bucket, world: int
                             ) -> CollectiveCall:
        """The exposed half of a bucket's sharded sync: a reduce-scatter of
        the W-aligned wire slot; the payload is the full padded input
        buffer at the wire dtype."""
        padded = ar.aligned_numel(bucket.numel, max(int(world), 1))
        wd = self.wire.wire_dtype or bucket_dtype(plan, bucket)
        return CollectiveCall(f"bucket:{bucket.index}", "reduce_scatter",
                              _dtype_name(wd), padded * _itemsize(wd))

    def _plan_deferred_allgather(self, plan: BucketPlan, world: int
                                 ) -> tuple[CollectiveCall, ...]:
        """The deferred half of sharded sync: one param all-gather per plan
        bucket (every bucket: once selected, a bucket's params keep moving
        under the optimizer's moments, and only the shard owner holds their
        authoritative values).  The payload is the local shard at the
        promoted param dtype (params go on the wire uncompressed)."""
        W = max(int(world), 1)
        calls = []
        for bucket in plan.buckets:
            padded = ar.aligned_numel(bucket.numel, W)
            pd = bucket_dtype(plan, bucket)
            calls.append(CollectiveCall(
                f"param-bucket:{bucket.index}", "all_gather", _dtype_name(pd),
                (padded // W) * _itemsize(pd), deferred=True,
            ))
        return tuple(calls)

    def plan_phase(self, plan: BucketPlan, phase: int, *, world: int = 1
                   ) -> CommSchedule:
        n = self.num_phases()
        ph = int(phase) % max(n, 1)
        sharded = self.sync_mode == "sharded"
        sel = (
            self.filter.select(plan, ph) if self.filter is not None
            else tuple(range(plan.num_buckets))
        )
        calls = tuple(
            self._plan_bucket_sharded(plan, plan.buckets[b], world) if sharded
            else self.wire.plan_bucket(plan, plan.buckets[b], world)
            for b in sel
        )
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
            sync="sharded" if sharded else "allreduce",
            deferred_calls=(
                self._plan_deferred_allgather(plan, world) if sharded else ()
            ),
        )

    # ---- execute ----------------------------------------------------------
    def execute(self, schedule: CommSchedule, grads: list[torch.Tensor],
                state: Any, *, step: int = 0, group=None):
        """-> (synced leaves, new state, stats).  ``grads`` and the residuals
        in ``state`` are lists of tensors in leaf order; neither is
        modified."""
        stats = SyncStats(schedule.bytes_per_worker, schedule.dense_bytes)
        if getattr(self.wire, "segmented", False):
            out, new_state = self._execute_segmented(schedule, grads, state,
                                                     step, group)
        else:
            out, new_state = self._execute_flat(schedule, grads, state, step,
                                                group)
        return out, new_state, stats

    def ef_coefficient(self, step: int) -> float | None:
        """The EF coefficient of ``step``; ``None`` without an EF stage,
        1 for classic EF (``schedule=None``), as in the reference."""
        if self.ef is None:
            return None
        if self.ef.schedule is None:
            return 1.0
        return self.ef.schedule.coefficient(step)

    def _engage(self, option: str, g: torch.Tensor) -> bool:
        """A kernel option: ``None`` engages the CUDA kernel on CUDA
        tensors only; ``False`` keeps the plain form; ``True`` on CPU
        tensors raises, since the kernel needs the GPU."""
        use = self.options.get(option)
        if use is None:
            return g.is_cuda
        if use and not g.is_cuda:
            raise ValueError(
                f"{option}=True needs CUDA tensors; the gradients are on {g.device}"
            )
        return bool(use)

    def _use_ef_kernel(self, g: torch.Tensor, r, coeff) -> bool:
        """The fused EF kernel (``kernels.ef_covap.ef_update``) replaces the
        two-op form on the per-segment path: one pass computes
        ``t = g + c*r`` and splits it into ``(send, r')``.  Applies to f32
        operands with EF on and a wire without a cast (a cast keeps its
        quantisation error in the residual)."""
        if not (coeff is not None and r is not None
                and self.wire.wire_dtype is None
                and g.dtype == torch.float32 and r.dtype == torch.float32):
            return False
        return self._engage("use_ef_kernel", g)

    def _use_pack_kernel(self, g: torch.Tensor, r, coeff) -> bool:
        """The fused pack kernel (``kernels.pack_ef_cast``) on the arena and
        sharded pack pass: one pass computes ``t = g + c*r``, the wire cast
        and the residual split, writing the wire values into the slot.
        Applies with EF on, a ``WireCast`` wire without a cast or with a
        bfloat16/float16 cast, and f32 operands."""
        if not (coeff is not None and r is not None
                and isinstance(self.wire, WireCast)
                and g.dtype == torch.float32 and r.dtype == torch.float32
                and self.wire.wire_dtype in (None, torch.bfloat16, torch.float16)):
            return False
        return self._engage("use_pack_kernel", g)

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

    # ---- zero-copy arena and sharded sync ---------------------------------
    def layout(self, plan: BucketPlan, selected: tuple[int, ...] | None = None,
               *, wire_dtype: torch.dtype | None = None, align: int = 1
               ) -> ar.ArenaLayout:
        """:func:`arena.build_layout`, built once per plan, selection, wire
        dtype and alignment: a layout depends on nothing else, so the step
        reuses it instead of re-planning it."""
        key = (id(plan), selected, wire_dtype, int(align))
        hit = self._layouts.get(key)
        if hit is None:
            # the entry holds the plan, so its id is not reused while cached
            hit = self._layouts[key] = (plan, ar.build_layout(
                plan, selected, wire_dtype=wire_dtype, align=align))
        return hit[1]

    def _arena_on(self) -> bool:
        """The ``use_arena`` option: bucket payloads live in static slots of
        flat per-phase planes."""
        return bool(self.options.get("use_arena", False))

    def _pack_segment(self, g, r, coeff, *, selected: bool,
                      wire_out: torch.Tensor | None,
                      r_out: torch.Tensor | None = None):
        """One segment through the fused pack + EF + cast pass.

        Writes the wire values into ``wire_out`` (the segment's flat range
        of its arena slot; ``None`` for an unselected bucket, which has no
        slot) and returns the new residual in the segment's shape:
        ``r_out`` itself when given (the segment's slice of the residual
        leaf), else a fresh tensor; ``None`` when EF is off.  A
        non-contiguous ``r_out`` (a sub-axis segment) is written through a
        flat temporary."""
        if r is None:
            if selected:
                wire_out.view(g.shape).copy_(g)
            return None
        dst = r_out if r_out is not None else torch.empty(
            g.shape, dtype=g.dtype, device=g.device)
        flat = dst.view(-1) if dst.is_contiguous() else torch.empty(
            g.numel(), dtype=g.dtype, device=g.device)
        gf, rf = g.reshape(-1), r.reshape(-1).to(g.dtype)
        if self._use_pack_kernel(g, r, coeff):
            from ..kernels.pack_ef_cast import pack_ef_cast_into

            pack_ef_cast_into(gf, rf, coeff, wire_out, flat, selected=selected)
        else:
            w, rnew = pack_ef_cast_ref(
                gf, rf, coeff, selected=selected,
                wire_dtype=wire_out.dtype if selected else None,
            )
            if selected:
                wire_out.copy_(w)
            flat.copy_(rnew)
        if not dst.is_contiguous():
            dst.copy_(flat.view(dst.shape))
        return dst

    def _reduce_scatter_slot(self, view: torch.Tensor, group) -> torch.Tensor:
        """One W-aligned slot view through the sharded collective: the
        reduce-scatter (mean) writes this worker's shard at its owner offset
        of an otherwise ZERO slot-sized vector, which is returned.  The
        zeros are the sharded contract: the optimizer's updates off the
        owned shard are overwritten by the next step's head all-gather.
        The identity with no group."""
        if group is None:
            return view
        S = view.numel() // world_size(group)
        full = torch.zeros_like(view)
        start = flat_axis_index(group) * S
        reduce_scatter(view, group, out=full[start:start + S])
        return full

    def execute_bucket(self, schedule: CommSchedule, b: int,
                       g_slices: Sequence[torch.Tensor],
                       r_slices: Sequence[torch.Tensor] | None = None, *,
                       coeff=None, key=None, group=None):
        """Synchronise ONE bucket: ``g_slices``/``r_slices`` are its
        segments' gradient and residual slices.

        Segmented wire: returns ``(synced_slices, resid_slices)``;
        ``synced_slices`` is ``None`` for an unselected bucket,
        ``resid_slices`` is ``None`` without EF.  The per-segment form only:
        the arena and sharded forms run over the whole tree
        (:meth:`_execute_segmented_arena`).

        Flat wire: ``g_slices`` are already compensated; returns
        ``(synced_slices, sent_slices)``, ``(None, None)`` for an unselected
        bucket.  ``key`` (Random-k's PRNG key) is not used by the ported
        wires."""
        selected = b in schedule.selected
        if not getattr(self.wire, "segmented", False):
            if not selected:
                return None, None
            flat = torch.cat([x.reshape(-1) for x in g_slices])
            synced_flat, sent_flat = self.wire.execute_bucket(
                flat, key, group, use_kernel=self._engage("use_wire_kernel", flat))
            return _split_like(g_slices, synced_flat), _split_like(g_slices, sent_flat)
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
    def _execute_segmented_arena(self, schedule, grads, state, step, group):
        """Arena form of :meth:`_execute_segmented`.  ONE pack pass writes
        every selected bucket's compensated, wire-cast payload into its
        static slot and every bucket's residual into the new residual leaf
        (the ``pack_ef_cast`` kernel where it applies); each selected
        bucket's collective runs in place on its slot view (a
        reduce-scatter of the W-aligned slot under sharded sync); the
        results go back to the leaves through static slices.  Unselected
        buckets have no slot: their pack writes only the residual."""
        plan = schedule.plan
        ef_on = self.ef is not None and _state_present(state)
        coeff = self.ef_coefficient(step) if ef_on else None
        sel = dict.fromkeys(schedule.selected)
        sharded = schedule.sync == "sharded"
        layout = self.layout(plan, tuple(sel), wire_dtype=self.wire.wire_dtype,
                             align=world_size(group) if sharded else 1)
        planes = layout.empty_planes(grads[0].device)
        resid = ar.empty_leaves(plan, grads) if ef_on else None

        # ---- pack pass: one streaming traversal of the gradient ----------
        for b in (range(plan.num_buckets) if ef_on else sel):
            selected = b in sel
            for si, seg in enumerate(plan.buckets[b].segments):
                self._pack_segment(
                    bk._slice_segment(grads[seg.leaf_idx], seg),
                    bk._slice_segment(state[seg.leaf_idx], seg) if ef_on else None,
                    coeff, selected=selected,
                    wire_out=layout.segment_view(planes, b, si) if selected else None,
                    r_out=bk._slice_segment(resid[seg.leaf_idx], seg) if ef_on else None,
                )

        # ---- wire pass: one collective per bucket, over a slot view -------
        synced = {}
        for b in sel:
            view = layout.bucket_view(planes, b)
            wired = (self._reduce_scatter_slot(view, group) if sharded
                     else pmean(view, group))
            synced[b] = layout.unpack_bucket(b, wired)

        # ---- reassembly: one write per segment ---------------------------
        out = ar.gather_leaves(
            plan, lambda b, si, seg: synced[b][si] if b in synced else None, grads,
        )
        return out, (resid if ef_on else state)

    @torch.no_grad()
    def _execute_segmented(self, schedule, grads, state, step, group):
        """Per-segment slices of every bucket.  With EF on, every bucket
        (selected or not) goes through :meth:`execute_bucket`, so the
        residual update fuses with the compensation.  The arena and sharded
        sync run :meth:`_execute_segmented_arena` instead."""
        if self._arena_on() or schedule.sync == "sharded":
            return self._execute_segmented_arena(schedule, grads, state, step, group)
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

    # ---- flat-bucket path (fp8wire, efsignsgd) ----------------------------
    @torch.no_grad()
    def _execute_flat_arena(self, schedule, grads, state, step, group):
        """Arena form of :meth:`_execute_flat`: the compensated tree is
        packed ONCE into per-dtype planes (static offsets, the element order
        of the concatenation), each selected bucket's wire stage runs on its
        slot view, and the synced and sent values return through static
        slices.  Bit for bit the per-bucket form."""
        plan = schedule.plan
        ef_on = self.ef is not None and _state_present(state)
        t = self.ef.compensated(grads, state, step) if ef_on else list(grads)
        sel = dict.fromkeys(schedule.selected)
        layout = self.layout(plan, tuple(sel))
        planes = ar.pack_leaves(layout, t)
        synced, sent = {}, {}
        for b in sel:
            view = layout.bucket_view(planes, b)
            synced_flat, sent_flat = self.wire.execute_bucket(
                view, None, group, use_kernel=self._engage("use_wire_kernel", view))
            synced[b] = layout.unpack_bucket(b, synced_flat)
            sent[b] = layout.unpack_bucket(b, sent_flat)
        out = ar.gather_leaves(
            plan, lambda b, si, seg: synced[b][si] if b in synced else None, t)
        if not ef_on:
            return out, state
        sent_leaves = ar.gather_leaves(
            plan, lambda b, si, seg: sent[b][si] if b in sent else None, t)
        return out, [a - s for a, s in zip(t, sent_leaves)]

    @torch.no_grad()
    def _execute_flat(self, schedule, grads, state, step, group):
        """Flat-bucket path: classic EF compensates the tree, each selected
        bucket's slices go through :meth:`execute_bucket` as one vector, and
        the residual is ``t - sent`` (unselected elements keep all of
        ``t``).  ``use_arena`` runs :meth:`_execute_flat_arena`."""
        if self._arena_on():
            return self._execute_flat_arena(schedule, grads, state, step, group)
        plan = schedule.plan
        ef_on = self.ef is not None and _state_present(state)
        t = self.ef.compensated(grads, state, step) if ef_on else list(grads)
        out = [torch.zeros_like(x) for x in t]
        sent = [torch.zeros_like(x) for x in t] if ef_on else None
        for b in dict.fromkeys(schedule.selected):
            segs = plan.buckets[b].segments
            slices = [bk._slice_segment(t[s.leaf_idx], s) for s in segs]
            synced_slices, sent_slices = self.execute_bucket(
                schedule, b, slices, key=None, group=group)
            for seg, xm, sv in zip(segs, synced_slices, sent_slices):
                bk._update_segment(out[seg.leaf_idx], seg, xm)
                if ef_on:
                    bk._update_segment(sent[seg.leaf_idx], seg, sv)
        if not ef_on:
            return out, state
        return out, [a - s for a, s in zip(t, sent)]
