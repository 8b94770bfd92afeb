"""Trace analysis: collective-byte accounting, the overlap and
sharded-placement checks, data-movement counts and roofline terms, the
counterpart of ``repro.launch.hlo_analysis``.

The reference reads a compiled module's HLO text.  The port has no compiled
module: its counterpart of the HLO text is one step's ``torch.profiler``
trace, recorded with ``record_shapes=True`` and loaded by
:func:`load_trace` as the Chrome-trace event list (each event a dict with
``name``, ``cat``, ``ts``, ``dur``, ``tid`` and ``args``).  Every function
here that takes ``trace`` takes that list.

* A collective is a host ``c10d::*`` event (``allreduce_``,
  ``_allgather_base_``, ``_reduce_scatter_base_``, ``alltoall_base_``).
  Its result bytes are its first tensor's ``Input Dims`` at its ``Input
  type``.  Where the type is a ``TensorList`` (an all-reduce) and says no
  dtype, and for the link, the event is read inside the
  ``collective/<link>/<dtype>`` span that :func:`count_collectives` opens
  around every call: the events do not name their process group, so the
  link is the group the call ran on.
* An eager trace is already unrolled, so the reference's while-loop
  helpers (``trip_aware``, ``_split_computations``, ``_trip_count``,
  ``computation_multipliers``) have no counterpart: every execution of a
  layer is its own event.
* The gradient-producing heavy ops are the backward pass's matrix products:
  ``aten::mm``/``addmm``/``bmm`` events inside an autograd
  ``evaluate_function`` span.

It is also the one home of the trace primitives the port's tools share
(``launch.profile_train`` reads its traces through them): the spans around
an event, device operations by correlation, kernel groups and intervals.

Wire model (ring algorithms), as the reference's: an all-reduce moves
``2 (n-1)/n`` of its buffer a device, the others about ``1x``; the estimate
counts factor 2 for an all-reduce, 1 otherwise.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import re
import tempfile
from typing import Iterable

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..core.ccr import HardwareSpec

# the trace's ``Input type`` names of the dtypes a collective may carry
_DTYPE_BYTES = {
    "float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2,
    "unsigned char": 1, "signed char": 1, "bool": 1, "short int": 2, "int": 4,
    "long int": 8, "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1,
    # the dtype names count_collectives writes into its spans
    "float32": 4, "float64": 8, "bfloat16": 2, "float16": 2, "uint8": 1,
    "int8": 1, "int16": 2, "int32": 4, "int64": 8, "float8_e4m3fn": 1,
    "float8_e5m2": 1,
}

# the host c10d ops the port's collectives dispatch to (``core.comm``), by
# the reference's collective kinds
_C10D_KINDS = {
    "c10d::allreduce_": "all-reduce",
    "c10d::_allgather_base_": "all-gather",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_base_": "all-to-all",
}
_SPAN = "collective/"
_GRAD_OPS = frozenset({"aten::mm", "aten::addmm", "aten::bmm"})
_BACKWARD = "autograd::engine::evaluate_function"


# kernel-name fragments, matched in order on the lower-cased name
GROUPS = (
    ("ef_update", ("ef_update_kernel",)),
    ("pack_ef_cast", ("pack_ef_cast_kernel",)),
    ("dequantize_fp8", ("dequantize_fp8_kernel",)),   # before its substring
    ("quantize_fp8", ("quantize_fp8_kernel",)),
    ("sign_compress", ("sign_compress_kernel",)),
    ("lowrank.matmul", ("lowrank_matmul_kernel", "lowrank_splitk_reduce_kernel")),
    ("threshold_filter", ("threshold_filter_kernel",)),
    ("adamw_fused", ("adamw_fused_kernel",)),
    ("qr", ("geqr", "orgqr", "ungqr", "larf", "householder", "cusolver", "magma")),
    ("nccl", ("nccl",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_")),
    ("softmax/logsumexp", ("softmax", "logsumexp")),
    ("copy/fill", ("copy", "fill", "memset", "memcpy", "cat")),
    ("elementwise/reduce", ("elementwise", "vectorized", "reduce", "unrolled",
                            "foreach")),
)


def kernel_group(name: str) -> str:
    """The group of :data:`GROUPS` a kernel's name falls in, or "other"."""
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def union(intervals: list[tuple[float, float]]) -> list[list[float]]:
    """The union of ``(start, end)`` intervals as sorted disjoint ``[start,
    end]`` pairs."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    return sum(e - s for s, e in union(intervals))


def load_trace(prof) -> list[dict]:
    """The complete (``ph == "X"``) events of a finished ``torch.profiler``
    profile (or of a Chrome-trace JSON file at that path), sorted by start."""
    if isinstance(prof, (str, os.PathLike)):
        with open(prof) as f:
            events = json.load(f)["traceEvents"]
    else:
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X"), key=lambda e: e["ts"])


def _host(e: dict) -> bool:
    return e.get("cat") in ("cpu_op", "user_annotation")


def event_end(e: dict) -> float:
    """When event ``e`` ends, on the trace's clock."""
    return e["ts"] + e.get("dur", 0.0)


def enclosing_spans(trace: list[dict], prefix: str
                    ) -> dict[int, list[tuple[float, float, str]]]:
    """Host spans whose names start with ``prefix``, by thread."""
    out: dict[int, list[tuple[float, float, str]]] = {}
    for e in trace:
        if _host(e) and e["name"].startswith(prefix):
            out.setdefault(e.get("tid"), []).append((e["ts"], event_end(e), e["name"]))
    return out


def innermost_span(spans, e: dict) -> str | None:
    """The name of the innermost span of ``spans`` (one thread's) that holds
    event ``e``, or ``None``."""
    best = None
    for s, t, name in spans.get(e.get("tid"), ()):
        if s <= e["ts"] and event_end(e) <= t and (best is None or s >= best[0]):
            best = (s, name)
    return None if best is None else best[1]


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int            # 0: not known from the event
    link: str | None           # from count_collectives's span
    ts: float
    line: str


def _numel(dims) -> int:
    n = 1
    for d in dims:
        n *= int(d)
    return n


def parse_collectives(trace: list[dict]) -> list[CollectiveOp]:
    """Every host collective of the trace in issue order, with its result
    bytes: an all-reduce's buffer, an all-gather's gathered output, a
    reduce-scatter's output shard, an all-to-all's output.  ``group_size``
    is read from the ratio of an all-gather's or reduce-scatter's output to
    its input."""
    spans = enclosing_spans(trace, _SPAN)
    ops = []
    for e in trace:
        kind = _C10D_KINDS.get(e["name"]) if e.get("cat") == "cpu_op" else None
        if kind is None:
            continue
        args = e.get("args", {})
        dims, types = args.get("Input Dims") or [[]], args.get("Input type") or [""]
        first, dtype = dims[0], types[0]
        span = innermost_span(spans, e)
        if first and isinstance(first[0], list):       # a TensorList: one tensor
            first = first[0]
        if dtype not in _DTYPE_BYTES:
            if span is None:
                raise ValueError(
                    f"{e['name']} names no dtype ({dtype!r}): record the step under "
                    "count_collectives, whose spans carry it")
            dtype = span.split("/")[2]
        result = _numel(first) * _DTYPE_BYTES[dtype]
        group = 0
        if kind in ("all-gather", "reduce-scatter") and len(dims) > 1 and dims[1]:
            a, b = _numel(dims[0]), _numel(dims[1])
            group = a // max(b, 1) if kind == "all-gather" else b // max(a, 1)
        ops.append(CollectiveOp(kind, result, group,
                                None if span is None else span.split("/")[1],
                                e["ts"], f"{e['name']} {first} {dtype}"))
    return ops


def _injected(op: CollectiveOp, g: int) -> float:
    """One worker's injected bytes, as the plan counts them: an
    all-gather's result is the W-fold gathered tensor, of which one worker
    contributed ``1/W``; a reduce-scatter's result is ``1/W`` of the buffer
    each worker fed in; the others' results are the per-worker buffer."""
    g = max(g, 1)
    if op.kind == "all-gather":
        return op.result_bytes / g
    if op.kind == "reduce-scatter":
        return op.result_bytes * g
    return float(op.result_bytes)


def collective_bytes_per_worker(trace: list[dict], world: int, *,
                                min_bytes: int = 0) -> float:
    """Per-worker *injected* bytes of every collective in the step, the
    number a compressor's static ``CommSchedule.bytes_per_worker`` must
    reproduce; ops below ``min_bytes`` (scalar metric all-reduces) are
    skipped."""
    total = 0.0
    for op in parse_collectives(trace):
        v = _injected(op, world)
        if v >= min_bytes:
            total += v
    return total


def group_link(group: list[int], intra_world: int) -> str:
    """Which link a collective group crosses, for a (pod, intra...) mesh
    laid out row-major with ``intra_world`` devices per pod: a group whose
    members span two pod blocks (``rank // intra_world`` differs) crosses
    the DCN; one confined to a single block stays on the ICI."""
    k = max(int(intra_world), 1)
    pods = {r // k for r in group}
    return "dcn" if len(pods) > 1 else "ici"


def collective_bytes_by_link(trace: list[dict], *, intra_world: int,
                             min_bytes: int = 0, world: int = 0) -> dict[str, float]:
    """Per-worker injected collective bytes of the step, split by link: the
    number the merged hierarchical ``CommSchedule.exposed_bytes_by_link``
    must reproduce.  Each op is normalised by its own group's size (read
    from its shapes where they show it, else ``world``); its link is the
    one :func:`count_collectives` recorded, else ``"dcn"`` for a group
    larger than ``intra_world``.  Ops below ``min_bytes`` are skipped."""
    out = {"ici": 0.0, "dcn": 0.0}
    for op in parse_collectives(trace):
        g = op.group_size or max(int(world), 1)
        link = op.link or ("dcn" if g > max(int(intra_world), 1) else "ici")
        v = _injected(op, g)
        if v >= min_bytes:
            out[link] = out.get(link, 0.0) + v
    return out


def collective_summary(trace: list[dict]) -> dict:
    """Ops, result bytes and count by kind, and the wire estimate (factor 2
    for an all-reduce, 1 otherwise) of the step's collectives."""
    by_kind: dict[str, dict] = {}
    buffer_bytes = wire = 0
    ops = parse_collectives(trace)
    for op in ops:
        d = by_kind.setdefault(op.kind, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += op.result_bytes
        buffer_bytes += op.result_bytes
        wire += (2 if op.kind == "all-reduce" else 1) * op.result_bytes
    return {"ops": len(ops), "by_kind": by_kind, "buffer_bytes": buffer_bytes,
            "wire_bytes_est": wire}


def wire_bytes_est(by_kind: dict[str, float]) -> float:
    """The wire model alone: ``{kind: buffer bytes}`` -> the estimate,
    factor 2 for an all-reduce, 1 otherwise."""
    return sum((2 if k == "all-reduce" else 1) * v for k, v in by_kind.items())


# ---------------------------------------------------------------------------
# counting collectives by the group they run on
# ---------------------------------------------------------------------------

# the trainer's reductions that are in no plan: the metric average and the
# sharded grad-norm sum
UNPLANNED = ("_pmean_metrics", "_sharded_grad_norm")


@contextlib.contextmanager
def count_collectives(links: dict):
    """Count the bytes each worker injects into the collectives of the
    groups in ``links`` (``group -> link name``), by link, as the plan counts
    them: an all-reduce's buffer, a reduce-scatter's whole input, an
    all-gather's local shard.  Calls made inside the trainer's
    :data:`UNPLANNED` functions go to a second dict.  Every call of a group
    in ``links`` runs inside a ``collective/<link>/<dtype>`` span, which a
    profiled step's trace then carries (:func:`parse_collectives`).  Yields
    the two ``link -> bytes`` dicts it fills, ``(counted, unplanned)``."""
    from ..train import trainer as trainer_mod

    counted: dict[str, int] = {}
    unplanned: dict[str, int] = {}
    inside = [0]
    saved = dist.all_reduce, dist.reduce_scatter_tensor, dist.all_gather_into_tensor
    saved_fns = {name: getattr(trainer_mod, name) for name in UNPLANNED}

    def noted(fn, group, t: torch.Tensor, *a, **k):
        link = links.get(group)
        if link is None:
            return fn(*a, group=group, **k)
        into = unplanned if inside[0] else counted
        into[link] = into.get(link, 0) + t.numel() * t.element_size()
        with record_function(f"{_SPAN}{link}/{str(t.dtype).removeprefix('torch.')}"):
            return fn(*a, group=group, **k)

    def all_reduce(tensor, *a, group=None, **k):
        return noted(saved[0], group, tensor, tensor, *a, **k)

    def reduce_scatter_tensor(output, input, *a, group=None, **k):
        return noted(saved[1], group, input, output, input, *a, **k)

    def all_gather_into_tensor(output, input, *a, group=None, **k):
        return noted(saved[2], group, input, output, input, *a, **k)

    def unplanned_call(fn):
        def call(*a, **k):
            inside[0] += 1
            try:
                return fn(*a, **k)
            finally:
                inside[0] -= 1
        return call

    dist.all_reduce, dist.reduce_scatter_tensor, dist.all_gather_into_tensor = (
        all_reduce, reduce_scatter_tensor, all_gather_into_tensor)
    for name, fn in saved_fns.items():
        setattr(trainer_mod, name, unplanned_call(fn))
    try:
        yield counted, unplanned
    finally:
        dist.all_reduce, dist.reduce_scatter_tensor, dist.all_gather_into_tensor = saved
        for name, fn in saved_fns.items():
            setattr(trainer_mod, name, fn)


# ---------------------------------------------------------------------------
# overlap interleaving checker (the fused overlap)
# ---------------------------------------------------------------------------

def grad_ops(trace: list[dict]) -> list[dict]:
    """The backward pass's matrix products in issue order: ``aten::mm``,
    ``addmm`` and ``bmm`` events inside an autograd ``evaluate_function``
    span (a checkpointed layer's recomputed forward runs there too; it
    precedes that layer's gradient products)."""
    spans = enclosing_spans(trace, _BACKWARD)
    return [e for e in trace if e.get("cat") == "cpu_op" and e["name"] in _GRAD_OPS
            and innermost_span(spans, e) is not None]


@dataclasses.dataclass(frozen=True)
class InterleaveReport:
    """Where one profiled step issues its gradient collectives.

    ``num_collectives`` counts bucket-sized collectives (result >=
    ``min_bytes``; scalar metric all-reduces are ignored), each at its
    *issue point*, its host ``c10d::`` event.  ``before_final_grad`` is how
    many of them the host issued before the final gradient-producing heavy
    op (the last backward matrix product).  ``independent`` is how many the
    host issued with at least one gradient-producing op still to come: an
    eager trace has no dataflow graph, but a collective issued before a
    backward product neither waited for it nor was waited for by it (the
    products read activations and upstream gradients, never a synced
    gradient), so it is the eager form of the reference's "neither
    ancestor nor descendant".  Positions index the time-ordered list of
    those collectives and products.

    On the card, ``device_buckets`` counts the buckets whose
    ``covap_bucket_{b}/phase_{p}`` span launched kernels, and
    ``device_early`` how many of them had their first kernel (EF or the
    collective's) start on the device before the last backward product's
    first kernel started; both are -1 without device events."""

    num_collectives: int
    num_grad_ops: int
    before_final_grad: int
    independent: int
    first_collective_pos: int
    last_grad_pos: int
    device_early: int = -1
    device_buckets: int = -1

    @property
    def interleaved(self) -> bool:
        """At least one collective is issued before the final backward
        (gradient-producing) product."""
        return self.num_collectives > 0 and self.before_final_grad >= 1


def launches_by_correlation(trace: list[dict], *, cats=("kernel",)
                            ) -> tuple[dict, dict]:
    """The device kernels (events of the categories ``cats``) by correlation
    id, and the host calls that launched them (the CUDA API events of the
    same correlation ids) by thread."""
    kernels = {e["args"]["correlation"]: e for e in trace
               if e.get("cat") in cats and "correlation" in e.get("args", {})}
    launches: dict[int, list[dict]] = {}
    for e in trace:
        if (e.get("cat", "").startswith("cuda_")
                and e.get("args", {}).get("correlation") in kernels):
            launches.setdefault(e.get("tid"), []).append(e)
    return kernels, launches


def _first_kernel_start(span: dict, kernels, launches) -> float | None:
    """The earliest device start of the kernels launched inside ``span``."""
    starts = [kernels[c["args"]["correlation"]]["ts"]
              for c in launches.get(span.get("tid"), ())
              if span["ts"] <= c["ts"] and event_end(c) <= event_end(span)]
    return min(starts) if starts else None


def device_overlap(trace: list[dict]) -> tuple[int, int]:
    """``(early, buckets)``: of the buckets whose ``covap_bucket_*`` span
    launched kernels, how many had their first kernel start on the device
    before the last backward product's first kernel started.  ``(-1, -1)``
    when the trace has no device kernels."""
    kernels, launches = launches_by_correlation(trace)
    if not kernels:
        return -1, -1
    last = None
    for op in grad_ops(trace):
        s = _first_kernel_start(op, kernels, launches)
        if s is not None:
            last = s if last is None else max(last, s)
    firsts = [_first_kernel_start(e, kernels, launches) for e in trace
              if _host(e) and e["name"].startswith("covap_bucket_")]
    firsts = [s for s in firsts if s is not None]
    if last is None:
        return 0, len(firsts)
    return sum(1 for s in firsts if s < last), len(firsts)


def ef_kernel_overlap(trace: list[dict], plan, issue_order, *,
                      kernel: str = "ef_update") -> tuple[int, int]:
    """``(early, buckets)``: how many buckets' EF kernels (``kernel``, a
    group of :func:`kernel_group`; one launch a segment)
    start on the device before the step's last matrix-product kernel,
    layer 0's last backward GEMM (nothing after layer 0's backward runs a
    matrix product), out of how many buckets launched them.
    ``issue_order`` is the order the buckets' kernels were launched in.
    Raises when the trace has no kernels, no matrix product, or not one EF
    kernel a segment."""
    kernels = [e for e in trace if e.get("cat") == "kernel"]
    if not kernels:
        raise ValueError("the profiler recorded no device kernels")
    gemms = [e for e in kernels if kernel_group(e["name"]) == "matmul"]
    if not gemms:
        raise ValueError("no matrix product in the trace")
    efs = [e for e in kernels if kernel_group(e["name"]) == kernel]
    owners = [b for b in issue_order for _ in plan.buckets[b].segments]
    if len(efs) != len(owners):
        raise ValueError(f"{len(efs)} {kernel} kernels in the trace, {len(owners)} "
                         "segments")
    last_gemm = max(e["ts"] for e in gemms)
    early = {b for b, e in zip(owners, efs) if e["ts"] < last_gemm}
    return len(early), len(set(owners))


def bucket_spans(trace: list[dict]) -> list[int]:
    """The buckets of the step's host ``covap_bucket_{b}/phase_{p}`` spans,
    in the order the hooks opened them."""
    return [int(e["name"].split("/")[0].removeprefix("covap_bucket_"))
            for e in trace if _host(e) and e["name"].startswith("covap_bucket_")]


def check_interleaving(trace: list[dict], *, min_bytes: int = 1024) -> InterleaveReport:
    """Does the step issue bucket collectives *inside* the backward pass?

    The overlap engine's claim: with the gradient-ready hooks a bucket's
    collective depends only on that bucket's gradients, so it is issued
    before the final gradient-producing product instead of after the
    whole backward pass.  See :class:`InterleaveReport`."""
    colls = [op.ts for op in parse_collectives(trace) if op.result_bytes >= min_bytes]
    grads = sorted(e["ts"] for e in grad_ops(trace))
    last_grad = grads[-1] if grads else None
    order = sorted([(t, 0) for t in colls] + [(t, 1) for t in grads])
    pos = {x: i for i, x in enumerate(order)}
    before = sum(1 for t in colls if last_grad is not None and t < last_grad)
    # issued with a gradient-producing op still to come
    independent = sum(1 for t in colls if bisect.bisect_right(grads, t) < len(grads))
    early, buckets = device_overlap(trace)
    return InterleaveReport(
        num_collectives=len(colls),
        num_grad_ops=len(grads),
        before_final_grad=before,
        independent=independent,
        first_collective_pos=pos[(min(colls), 0)] if colls else -1,
        last_grad_pos=pos[(last_grad, 1)] if grads else -1,
        device_early=early,
        device_buckets=buckets,
    )


# ---------------------------------------------------------------------------
# sharded-sync placement checker (reduce-scatter / all-gather)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedPlacementReport:
    """Where a sharded step issues its two collective halves.

    The gradient reduce-scatters must be issued inside the backward pass
    (``rs_before_final_grad`` counts those issued before the final
    gradient-producing product), and the deferred param all-gathers at the
    HEAD of the step, before the backward even begins (``ag_before_first_rs``
    counts those issued before the first reduce-scatter: the forward pass
    they overlap lies between the two).  Bucket-sized collectives only
    (``min_bytes``)."""

    num_reduce_scatter: int
    num_all_gather: int
    rs_before_final_grad: int
    ag_before_first_rs: int
    first_ag_pos: int
    first_rs_pos: int
    last_grad_pos: int

    @property
    def placed(self) -> bool:
        """RS inside the backward pass AND AG at the step head."""
        return (
            self.num_reduce_scatter > 0
            and self.num_all_gather > 0
            and self.rs_before_final_grad >= 1
            and self.ag_before_first_rs >= 1
        )


def check_sharded_placement(trace: list[dict], *, min_bytes: int = 1024,
                            world: int = 1) -> ShardedPlacementReport:
    """Prove the sharded-sync order on one profiled step: the head param
    all-gathers issued first (they overlap the forward), the gradient
    reduce-scatters issued before the final gradient-producing product
    (they overlap the backward).  A reduce-scatter's result is the ``1/W``
    shard of its bucket, so its size filter is ``min_bytes / world``; an
    all-gather's result is the gathered buffer and filters at
    ``min_bytes``.  Positions index the time-ordered list of the step's
    collectives and backward products."""
    ops = parse_collectives(trace)
    rs = [op.ts for op in ops if op.kind == "reduce-scatter"
          and op.result_bytes >= min_bytes // max(world, 1)]
    ag = [op.ts for op in ops if op.kind == "all-gather"
          and op.result_bytes >= min_bytes]
    grads = [e["ts"] for e in grad_ops(trace)]
    last_grad = max(grads) if grads else None
    order = sorted([(t, 0) for t in rs] + [(t, 1) for t in ag] + [(t, 2) for t in grads])
    pos = {x: i for i, x in enumerate(order)}
    first_rs = min(rs) if rs else None
    return ShardedPlacementReport(
        num_reduce_scatter=len(rs),
        num_all_gather=len(ag),
        rs_before_final_grad=sum(1 for t in rs if last_grad is not None and t < last_grad),
        ag_before_first_rs=sum(1 for t in ag if first_rs is None or t < first_rs),
        first_ag_pos=pos[(min(ag), 1)] if ag else -1,
        first_rs_pos=pos[(first_rs, 0)] if rs else -1,
        last_grad_pos=pos[(last_grad, 2)] if grads else -1,
    )


# ---------------------------------------------------------------------------
# data-movement accounting: the zero-copy arena gate
# ---------------------------------------------------------------------------

# the copy-type ops a gather/scatter bucket rebuild issues: explicit copies,
# per-segment concatenations and indexed writes, and on the card the
# device-to-device memcpys.  Static views (``aten::slice``, ``view``) are
# not counted, as the reference leaves out ``slice``: an arena bucket view
# is one and moves nothing
DATA_MOVEMENT_OPS = frozenset(
    {"aten::copy_", "aten::cat", "aten::index_copy_", "aten::slice_scatter"})
DEVICE_COPY = "Memcpy DtoD"


def count_data_movement(trace: list[dict], *, ops: frozenset[str] | None = None
                        ) -> dict:
    """Count the step's data-movement ops: ``{op: count, ..., "total": n}``,
    ``DEVICE_COPY`` counting the device-to-device memcpys.  The arena gate
    compares an arena-on and an arena-off step: losing the per-segment
    concatenate/split chains shows as strictly fewer of these."""
    ops = DATA_MOVEMENT_OPS if ops is None else ops
    out: dict[str, int] = {k: 0 for k in sorted(ops)}
    out[DEVICE_COPY] = 0
    for e in trace:
        if e.get("cat") == "cpu_op" and e["name"] in ops:
            out[e["name"]] += 1
        elif e.get("cat") == "gpu_memcpy" and e["name"].startswith(DEVICE_COPY):
            out[DEVICE_COPY] += 1
    out["total"] = sum(out.values())
    return out


def data_movement_delta(trace_off: list[dict], trace_on: list[dict]) -> dict:
    """Arena gate digest: data-movement counts of the legacy (``off``) and
    the arena (``on``) step, and the delta.  ``delta["total"]`` must be
    positive for the arena claim to hold."""
    off = count_data_movement(trace_off)
    on = count_data_movement(trace_on)
    return {"off": off, "on": on, "delta": {k: off[k] - on[k] for k in off}}


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

_H100 = HardwareSpec.h100_sxm()


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(
    *,
    flops_per_device: float,
    hbm_bytes_per_device: float,
    wire_bytes_per_device: float,
    peak_flops: float = _H100.peak_flops,
    hbm_bw: float = _H100.hbm_bw,
    ici_bw: float = _H100.ici_bw,
) -> RooflineTerms:
    """Seconds of each term; the rates default to the H100's
    (``HardwareSpec.h100_sxm``)."""
    return RooflineTerms(
        compute_s=flops_per_device / peak_flops,
        memory_s=hbm_bytes_per_device / hbm_bw,
        collective_s=wire_bytes_per_device / ici_bw,
    )


def count_hlo_ops(trace: list[dict], names: Iterable[str]) -> dict[str, int]:
    """How many events of the trace carry each of ``names`` as a word of
    their name."""
    names = list(names)
    out = {n: 0 for n in names}
    pats = {n: re.compile(rf"(?<![\w:]){re.escape(n)}(?![\w:])") for n in names}
    for e in trace:
        for n in names:
            if pats[n].search(e.get("name", "")):
                out[n] += 1
    return out
