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

Each form syncs one bucket in two halves (:class:`StepSync`): the start runs
EF (and the pack in the arena forms), writes the new residual, which needs
no wire, and starts the collective without waiting; the finish waits and
writes the synced values.  The post path finishes each bucket right after
its start; the fused overlap (``core.overlap``) starts each bucket inside
the backward pass and finishes them all after it.

A flat wire (``FP8Block``, ``SignCompress``) sees each selected bucket as
one flat vector: classic EF compensates the whole tree (``t = g + r``), each
selected bucket's compensated slices are concatenated, the wire stage
encodes, all-gathers and decodes them, and the residual is ``t - sent``,
where ``sent`` is this worker's own decoded contribution.  With
``use_arena=True`` the compensated tree is packed once into flat planes and
each wire stage runs on its bucket's slot view.  On CUDA tensors the wire
stages run the ``quantize_fp8`` / ``dequantize_fp8`` and ``sign_compress``
kernels.

A leaf-granularity wire (``LowRank``, PowerSGD) sees each leaf whole:
classic EF compensates it (``t = g + r``), a leaf of two or more dimensions
is reshaped to a batch of matrices ``M`` and synced as its rank-r
factorisation (``P = M@Q``, all-reduce, QR, ``Q' = M^T@P``, all-reduce,
``approx = P@Q'^T``; the three products run the ``lowrank.matmul`` kernel
on CUDA tensors), a smaller leaf is all-reduced densely, and the residual
is ``t - approx``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

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
    start_pmean,
    start_reduce_scatter,
    world_size,
)
from .error_feedback import EFSchedule, init_residual
from .filter import selected_buckets
from .schedule import CollectiveCall, CommSchedule
from ..kernels.ref import (
    FP8_BLOCK,
    dequantize_fp8_ref,
    matmul_ref,
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
    op, wire dtype); ``execute_bucket`` / ``start_segment`` the executed
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

    def start_segment(self, x: torch.Tensor, group):
        """Start one segment's all-reduce -> ``(buffer, residual, work)``:
        the mean lands in ``buffer`` (``x`` itself, or its wire cast) once
        ``work`` has waited (``work`` is ``None`` with no group).  ``x`` is a
        fresh tensor that the all-reduce may overwrite."""
        if self.wire_dtype is not None and x.dtype != self.wire_dtype:
            xw = x.to(self.wire_dtype)
            resid = x - xw.to(x.dtype)       # before the in-place reduce
            return xw, resid, start_pmean(xw, group)
        return x, torch.zeros_like(x), start_pmean(x, group)

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


def _as_batched_matrix(x: torch.Tensor) -> torch.Tensor:
    """A leaf of two or more dimensions as a batch of matrices over its last
    two axes: ``(a, b) -> (1, a, b)``, ``(L, a, b) -> (L, a, b)``."""
    return x.reshape((-1,) + tuple(x.shape[-2:]))


class LowRank:
    """PowerSGD's rank-r factorised all-reduce, per leaf of two or more
    dimensions (batched over its leading stack axes); smaller leaves are
    all-reduced densely.  Communication per matrix: ``(a + b) * r`` words
    by all-reduce."""

    granularity = "leaf"
    op = "all_reduce"

    def __init__(self, rank: int = 2, seed: int = 0):
        self.rank = int(rank)
        self.seed = int(seed)

    def init_state(self, params: Sequence[torch.Tensor], plan: BucketPlan, *,
                   use_ef: bool) -> dict:
        """``{"q": [...], "residual": [...]}`` in leaf order: a normal
        ``(B, b, rank)`` starting Q for each leaf of two or more dimensions
        (``None`` for the rest), drawn on the CPU from one ``torch.Generator``
        seeded with ``seed``, in leaf order, so every device starts from the
        same Q; zero residuals with EF on, ``None`` without.  The reference
        draws its Q from ``jax.random``: ``interop.compressor_state_from_jax``
        carries it over where two runs must start alike."""
        gen = torch.Generator().manual_seed(self.seed)
        qs, resid = [], []
        for leaf in params:
            if leaf.dim() >= 2:
                shape = (math.prod(leaf.shape[:-2]), leaf.shape[-1], self.rank)
                qs.append(torch.randn(shape, generator=gen, dtype=leaf.dtype)
                          .to(leaf.device))
            else:
                qs.append(None)
            resid.append(torch.zeros_like(leaf) if use_ef else None)
        return {"q": qs, "residual": resid}

    def plan_leaf(self, leaf_idx: int, shape: tuple[int, ...], dtype: torch.dtype
                  ) -> CollectiveCall:
        if len(shape) >= 2:
            B = math.prod(shape[:-2])
            a, b = shape[-2], shape[-1]
            payload = B * (a + b) * self.rank * _itemsize(dtype)
        else:
            payload = math.prod(shape) * _itemsize(dtype)
        return CollectiveCall(f"leaf:{leaf_idx}", "all_reduce", _dtype_name(dtype),
                              payload)

    def execute_leaf(self, t: torch.Tensor, q: torch.Tensor | None, group, *,
                     use_kernel: bool = False):
        """-> ``(approx, new_q)``; a dense mean for a leaf without a Q.  The
        three products run the ``lowrank.matmul`` CUDA kernel when
        ``use_kernel``, else :func:`~repro_torch.kernels.ref.matmul_ref`;
        the QR is ``torch.linalg.qr`` either way.  ``t`` is not modified."""
        if q is None:
            return pmean(t.clone(), group), None
        if use_kernel:
            from ..kernels.lowrank import matmul
        else:
            matmul = matmul_ref
        m = _as_batched_matrix(t)
        p = pmean(matmul(m, q), group)
        p, _ = torch.linalg.qr(p)                 # orthonormal columns
        qn = pmean(matmul(m, p, trans_a=True), group)
        approx = matmul(p, qn, trans_b=True).reshape(t.shape)
        return approx, qn

    def __repr__(self):
        return f"LowRank(rank={self.rank})"


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
    ``use_wire_kernel`` (the wire stage's kernels: the flat wires' encode
    and decode, ``LowRank``'s products) (``None``: the CUDA kernel on CUDA
    tensors, the plain form on CPU tensors; ``False``: the plain form
    everywhere; ``True`` on CPU tensors raises), ``use_arena`` and ``sync``
    (``"allreduce"`` or ``"sharded"``; only a segmented bucket wire takes
    ``"sharded"``)."""

    name = "pipeline"

    def __init__(self, *, wire: WireStage | LowRank,
                 filter: CoarseFilter | None = None,
                 ef: ErrorFeedback | None = None, **opts):
        super().__init__(**opts)
        self.wire = wire
        self.filter = filter
        self.ef = ef
        self._layouts: dict = {}
        if self.granularity == "leaf" and filter is not None:
            raise ValueError("CoarseFilter requires bucket granularity")
        sync = self.options.get("sync", "allreduce") or "allreduce"
        if sync not in ("allreduce", "sharded"):
            raise ValueError(f"sync must be 'allreduce' or 'sharded', got {sync!r}")
        if sync == "sharded" and not (self.granularity == "bucket"
                                      and getattr(self.wire, "segmented", False)):
            raise ValueError(
                "sync='sharded' requires a segmented bucket pipeline "
                f"(covap / none / fp16); {self.wire!r} must use sync='allreduce'"
            )

    @property
    def granularity(self) -> str:
        """``"bucket"``, or ``"leaf"`` for a wire that syncs whole leaves
        (``LowRank``)."""
        return getattr(self.wire, "granularity", "bucket")

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
        if self.granularity == "leaf":
            return self.wire.init_state(params, plan, use_ef=self.ef is not None)
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
        ready_ranks: tuple[int, ...] = ()
        if self.granularity == "leaf":
            sel = tuple(range(len(plan.leaf_shapes)))
            calls = tuple(self.wire.plan_leaf(i, plan.leaf_shapes[i],
                                              plan.leaf_dtypes[i]) for i in sel)
        else:
            sel = (
                self.filter.select(plan, ph) if self.filter is not None
                else tuple(range(plan.num_buckets))
            )
            calls = tuple(
                self._plan_bucket_sharded(plan, plan.buckets[b], world) if sharded
                else self.wire.plan_bucket(plan, plan.buckets[b], world)
                for b in sel
            )
            ready = bk.build_ready_order(plan)
            ready_ranks = tuple(ready.rank_of(b) for b in sel)
        return CommSchedule(
            compressor=self.name,
            phase=ph,
            num_phases=max(n, 1),
            granularity=self.granularity,
            selected=tuple(sel),
            calls=calls,
            dense_bytes=dense_bytes(plan),
            world=world,
            plan=plan,
            ready_ranks=ready_ranks,
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
        if self.granularity == "leaf":
            out, new_state = self._execute_leaf(grads, state, group)
        elif getattr(self.wire, "segmented", False):
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

    def _start_segment(self, g, r, coeff, *, selected: bool, group):
        """One segment through EF ∘ filter-decision, its all-reduce started.
        Returns ``(buffer, resid, work)``: the buffer the mean lands in once
        ``work`` has waited (``None`` for an unselected bucket) and the new
        residual (``None`` when EF is off)."""
        if self._use_ef_kernel(g, r, coeff):
            from ..kernels.ef_covap import ef_update

            send, rnew = ef_update(
                g.reshape(-1), r.reshape(-1), coeff, selected=selected
            )
            rnew = rnew.view(g.shape)
            if not selected:
                return None, rnew, None
            buf = send.view(g.shape)
            return buf, rnew, start_pmean(buf, group)
        if r is None:
            t = g.clone() if selected else g
        else:
            t = g + coeff * r.to(g.dtype)
        if not selected:
            return None, (t if r is not None else None), None
        buf, resid, work = self.wire.start_segment(t, group)
        return buf, (resid if r is not None else None), work

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

    def _start_reduce_scatter_slot(self, view: torch.Tensor, group):
        """Start one W-aligned slot view's sharded collective -> ``(full,
        work)``: the reduce-scatter (mean) writes this worker's shard at its
        owner offset of the otherwise ZERO slot-sized ``full``.  The zeros
        are the sharded contract: the optimizer's updates off the owned
        shard are overwritten by the next step's head all-gather.  ``(view,
        None)`` with no group."""
        if group is None:
            return view, None
        S = view.numel() // world_size(group)
        full = torch.zeros_like(view)
        start = flat_axis_index(group) * S
        return full, start_reduce_scatter(view, group, out=full[start:start + S])

    def start_bucket(self, schedule: CommSchedule, b: int,
                     g_slices: Sequence[torch.Tensor],
                     r_slices: Sequence[torch.Tensor] | None = None, *,
                     coeff=None, group=None, layout: ar.ArenaLayout | None = None,
                     planes: Sequence[torch.Tensor] | None = None,
                     r_out: Sequence[torch.Tensor] | None = None) -> "PendingBucket":
        """The start of ONE segmented bucket's sync: EF on every segment,
        the new residuals written, and the bucket's collective started
        without waiting.

        * per-segment form: the ``ef_update`` kernel (or the plain form)
          and one all-reduce per segment;
        * arena form (``use_arena``): the ``pack_ef_cast`` pass writes the
          segments into the bucket's slot of ``planes`` (``layout``'s; a
          one-bucket layout when ``None``), and one all-reduce runs in place
          on the slot view;
        * sharded form (``sync="sharded"``): as the arena form, with a
          W-aligned slot and a reduce-scatter into the owner's shard.

        ``r_out`` (arena forms) are the residual slices to write into;
        otherwise the residuals are fresh tensors."""
        if not getattr(self.wire, "segmented", False):
            raise ValueError(f"{self.wire!r} is not a segmented wire: its buckets "
                             "go through execute_bucket whole")
        selected = b in schedule.selected
        ef_on = r_slices is not None
        rs = r_slices if ef_on else (None,) * len(g_slices)
        sharded = schedule.sync == "sharded"
        if not (sharded or self._arena_on()):
            bufs, resids, works = [], [], []
            for g, r in zip(g_slices, rs):
                buf, rr, work = self._start_segment(g, r, coeff, selected=selected,
                                                    group=group)
                bufs.append(buf)
                resids.append(rr)
                works.append(work)
            return PendingBucket(b, works, (lambda: bufs) if selected else None,
                                 resids if ef_on else None)
        if layout is None:
            layout = self.layout(schedule.plan, (b,), wire_dtype=self.wire.wire_dtype,
                                 align=world_size(group) if sharded else 1)
            planes = layout.empty_planes(g_slices[0].device) if selected else None
        outs = r_out if r_out is not None else (None,) * len(g_slices)
        resids = [
            self._pack_segment(g, r, coeff, selected=selected,
                               wire_out=layout.segment_view(planes, b, si) if selected else None,
                               r_out=ro)
            for si, (g, r, ro) in enumerate(zip(g_slices, rs, outs))
        ]
        if not selected:
            return PendingBucket(b, [], None, resids if ef_on else None)
        view = layout.bucket_view(planes, b)
        if sharded:
            full, work = self._start_reduce_scatter_slot(view, group)
        else:
            full, work = view, start_pmean(view, group)
        return PendingBucket(b, [work], lambda: layout.unpack_bucket(b, full),
                             resids if ef_on else None)

    def execute_bucket(self, schedule: CommSchedule, b: int,
                       g_slices: Sequence[torch.Tensor],
                       r_slices: Sequence[torch.Tensor] | None = None, *,
                       coeff=None, key=None, group=None):
        """Synchronise ONE bucket: ``g_slices``/``r_slices`` are its
        segments' gradient and residual slices.

        Segmented wire: returns ``(synced_slices, resid_slices)``;
        ``synced_slices`` is ``None`` for an unselected bucket,
        ``resid_slices`` is ``None`` without EF: :meth:`start_bucket` in the
        form the options pick (per-segment, arena or sharded, the last two
        over a one-bucket slot), then the wait.  Under sharded sync a synced
        slice holds the mean on this worker's shard and zeros elsewhere.

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
        pending = self.start_bucket(schedule, b, g_slices, r_slices, coeff=coeff,
                                    group=group)
        synced = pending.finish()
        if synced is not None:
            synced = [x.to(g.dtype) for x, g in zip(synced, g_slices)]
        return synced, pending.resids

    @torch.no_grad()
    def _execute_segmented(self, schedule, grads, state, step, group):
        """Every bucket through :class:`StepSync`, each started and finished
        in turn (with EF on every bucket, selected or not, so the residual
        update fuses with the compensation; without EF the selected ones)."""
        sync = StepSync(self, schedule, grads, state, step=step, group=group)
        for b in sync.todo():
            sync.start(b, sync.grad_slices(b, grads))
            sync.finish(b)
        return sync.close()

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

    # ---- leaf-granularity path (PowerSGD) ---------------------------------
    def execute_leaf_one(self, leaf_idx: int, t: torch.Tensor, q, group):
        """Sync one compensated leaf through the leaf wire ->
        ``(approx, new_q)``."""
        return self.wire.execute_leaf(
            t, q, group, use_kernel=self._engage("use_wire_kernel", t))

    @torch.no_grad()
    def _execute_leaf(self, grads, state, group):
        """Leaf-granularity path: classic EF (``t = g + r``) folded into the
        per-leaf loop; ``residual' = t - approx`` (zeros for a densely
        all-reduced leaf)."""
        out, new_qs, new_resid = [], [], []
        for li, (g, q, r) in enumerate(zip(grads, state["q"], state["residual"])):
            t = g + r.to(g.dtype) if r is not None else g
            approx, qn = self.execute_leaf_one(li, t, q, group)
            out.append(approx)
            new_qs.append(qn)
            if r is None:
                new_resid.append(None)
            else:
                new_resid.append(torch.zeros_like(t) if qn is None else t - approx)
        return out, {"q": new_qs, "residual": new_resid}


@dataclasses.dataclass
class PendingBucket:
    """One segmented bucket's sync, started (:meth:`SyncPipeline.start_bucket`).

    ``resids`` are its new residual slices (``None`` without EF), already
    written.  :meth:`finish` waits for its collectives and returns its synced
    slices at the wire dtype, segment-shaped (``None`` for an unselected
    bucket, which sends nothing)."""

    b: int
    works: list
    synced: Callable[[], list] | None
    resids: list | None

    def finish(self) -> list | None:
        for work in self.works:
            if work is not None:
                work.wait()
        self.works = []
        return self.synced() if self.synced is not None else None


class StepSync:
    """One step's sync of a segmented pipeline, one bucket at a time.

    :meth:`start` runs bucket ``b``'s EF (the ``ef_update`` kernel, or the
    ``pack_ef_cast`` kernel writing into the bucket's slot of the step's
    arena planes in the arena and sharded forms), writes its new residual
    and starts its collective; :meth:`finish` waits for it and writes its
    synced values into the output leaves; :meth:`close` zeros every segment
    no selected bucket wrote and returns ``(synced leaves, new state)``.
    The post path finishes each bucket right after its start; the fused
    overlap starts them inside the backward pass, in the order their
    gradients land, and finishes them all after it.  Either way each
    bucket runs the same operations on the same values.

    ``like`` gives the gradients' shapes and dtypes; ``events`` records
    ``("start", b)`` and ``("wait", b)`` in the order they happen."""

    def __init__(self, pipeline: SyncPipeline, schedule: CommSchedule,
                 like: Sequence[torch.Tensor], state, *, step: int, group):
        self.pipeline, self.schedule, self.group = pipeline, schedule, group
        self.plan = plan = schedule.plan
        self.state = state
        self.ef_on = pipeline.ef is not None and _state_present(state)
        self.coeff = pipeline.ef_coefficient(step) if self.ef_on else None
        self.selected = dict.fromkeys(schedule.selected)
        sharded = schedule.sync == "sharded"
        self.arena = sharded or pipeline._arena_on()
        self.layout = (pipeline.layout(plan, tuple(self.selected),
                                       wire_dtype=pipeline.wire.wire_dtype,
                                       align=world_size(group) if sharded else 1)
                       if self.arena else None)
        # allocated at the first start (planes, residuals) and the first
        # finish (outputs): under the fused overlap, not before the forward
        self.like = like
        self.planes = self.out = self.resid = None
        self.pending: dict[int, PendingBucket] = {}
        self.started: list[int] = []
        self.written: set[int] = set()
        self.events: list[tuple[str, int]] = []

    def _outputs(self) -> None:
        if self.out is None:
            self.out = ar.empty_leaves(self.plan, self.like)

    def todo(self) -> tuple[int, ...]:
        """The buckets to start: every bucket with EF on, else the selected."""
        return tuple(range(self.plan.num_buckets)) if self.ef_on else tuple(self.selected)

    def grad_slices(self, b: int, grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return [bk._slice_segment(grads[s.leaf_idx], s)
                for s in self.plan.buckets[b].segments]

    @torch.no_grad()
    def start(self, b: int, g_slices: Sequence[torch.Tensor]) -> None:
        if not self.started:
            if self.arena:
                self.planes = self.layout.empty_planes(self.like[0].device)
            if self.ef_on:
                self.resid = ar.empty_leaves(self.plan, self.like)
        segs = self.plan.buckets[b].segments
        r_slices = r_out = None
        if self.ef_on:
            r_slices = [bk._slice_segment(self.state[s.leaf_idx], s) for s in segs]
            if self.arena:
                r_out = [bk._slice_segment(self.resid[s.leaf_idx], s) for s in segs]
        pending = self.pipeline.start_bucket(
            self.schedule, b, g_slices, r_slices, coeff=self.coeff, group=self.group,
            layout=self.layout, planes=self.planes, r_out=r_out)
        if self.ef_on and not self.arena:
            for seg, rr in zip(segs, pending.resids):
                bk._update_segment(self.resid[seg.leaf_idx], seg, rr)
        pending.resids = None               # written into the residual leaves
        self.pending[b] = pending
        self.started.append(b)
        self.events.append(("start", b))

    @torch.no_grad()
    def finish(self, b: int) -> None:
        pending = self.pending.pop(b)
        self.events.append(("wait", b))
        synced = pending.finish()
        if synced is None:
            return
        self._outputs()
        for seg, x in zip(self.plan.buckets[b].segments, synced):
            bk._update_segment(self.out[seg.leaf_idx], seg, x)
        self.written.add(b)

    @torch.no_grad()
    def close(self):
        if self.pending:
            raise RuntimeError(f"buckets {sorted(self.pending)} were started and "
                               "never finished")
        missing = sorted(set(self.todo()) - set(self.started))
        if missing:
            raise RuntimeError(f"buckets {missing} were never started")
        self._outputs()
        for b, bucket in enumerate(self.plan.buckets):
            if b not in self.written:
                for seg in bucket.segments:
                    bk._slice_segment(self.out[seg.leaf_idx], seg).zero_()
        return self.out, (self.resid if self.ef_on else self.state)
