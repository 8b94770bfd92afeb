"""The paper's analytical performance model, equations (1)-(6), and the
bucket-timeline simulator of its Figs. 1/4/5/11: the counterpart of
``repro.core.perfmodel``, plain float arithmetic in the same order.

All times in seconds; all speedups relative to single-worker linear scaling
(upper limit = P, the number of workers).

A per-link bandwidth mapping prices each ``CollectiveCall`` on its own
``link`` (``"ici"`` intra-pod, ``"dcn"`` across pods).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence, Union

import torch

from .bucketing import build_ready_order

# ---- eq (1)/(2): plain DP ---------------------------------------------------

def t_dp(t_before: float, t_comp: float, t_comm: float) -> float:
    return t_before + t_comp + t_comm


def speedup_dp(P: int, t_before: float, t_comp: float, t_comm: float) -> float:
    """Eq (2): P * k / (k + CCR), k = T_before/T_comp + 1."""
    k = t_before / t_comp + 1.0
    ccr = t_comm / t_comp
    return P * k / (k + ccr)


# ---- eq (3): tensor-based overlapping timeline ------------------------------

def simulate_overlap(
    t_before: float,
    comp_times: Sequence[float],
    comm_times: Sequence[float],
) -> dict:
    """Simulate one iteration of bucketed overlapped DP (Fig. 1(b)/(d)).

    Bucket i's communication may start once (a) its gradients are computed
    and (b) the previous bucket's communication finished (collectives are
    ordered on the interconnect).  Returns total time + bubble accounting
    (the idle interconnect slots of eq (3))."""
    assert len(comp_times) == len(comm_times)
    t = t_before
    comm_free = t_before
    bubbles = 0.0
    for comp, comm in zip(comp_times, comm_times):
        t += comp  # gradient of this bucket ready
        start = max(t, comm_free)
        if comm > 0 and start > comm_free and comm_free > t_before:
            bubbles += start - comm_free
        comm_free = start + comm
    total = max(t, comm_free)
    return {
        "total": total,
        "compute_end": t,
        "comm_end": comm_free,
        "bubbles": bubbles,
        "exposed_comm": max(0.0, comm_free - t),
        "comm_total": float(sum(comm_times)),
    }


def overlap_fraction(sim: dict) -> float:
    """Fraction of a timeline's communication hidden under compute:
    ``1 - exposed/total`` (1.0 when the phase moves no bytes).  Works on
    any :func:`simulate_overlap` / :func:`simulate_schedule` result."""
    comm = sim.get("comm_total", 0.0)
    if comm <= 0.0:
        return 1.0
    return max(0.0, 1.0 - sim.get("exposed_comm", 0.0) / comm)


def achieved_overlap_fraction(
    t_comp: float, t_comm: float, t_step: float
) -> float:
    """Measured counterpart of :func:`overlap_fraction`: with compute time
    ``t_comp`` (collective-free sub-program), wire time ``t_comm``
    (schedule-only sub-program) and the full step's wall time, the hidden
    communication is ``t_comp + t_comm - t_step`` — clamped to [0, 1] of
    ``t_comm``.  This is the number the overlap engine is judged by:
    predicted (:func:`overlap_fraction` on the planned timeline) vs
    achieved (this, from ``runtime.monitor`` probes)."""
    if t_comm <= 0.0:
        return 1.0
    hidden = t_comp + t_comm - t_step
    return max(0.0, min(1.0, hidden / t_comm))


def t_ovlp(t_before: float, t_comp: float, t_comm: float, n_buckets: int = 8) -> float:
    """Eq (4) via the simulator with uniform buckets."""
    comp = [t_comp / n_buckets] * n_buckets
    comm = [t_comm / n_buckets] * n_buckets
    return simulate_overlap(t_before, comp, comm)["total"]


def speedup_ovlp(P: int, t_before: float, t_comp: float, t_comm: float) -> float:
    ls = t_before + t_comp
    return P * ls / t_ovlp(t_before, t_comp, t_comm)


# ---- eq (5)/(6): GC and GC+overlap ------------------------------------------

def t_gc(
    t_before: float, t_comp: float, t_comm_gc: float, t_compress: float
) -> float:
    """Eq (5): compression is serial between compute and communication."""
    return t_before + t_comp + t_compress + t_comm_gc


def t_gc_ovlp(
    t_before: float,
    t_comp: float,
    t_comm_gc: float,
    t_compress: float,
    n_buckets: int = 8,
    data_dependency: bool = False,
) -> float:
    """Eq (6) via the simulator.  With ``data_dependency`` (Fig. 1(e)) the
    scheme's synchronous exchange serialises compression+communication after
    compute — overlap is lost (Ok-topk-style)."""
    if data_dependency:
        return t_before + t_comp + t_compress + t_comm_gc
    comp = [(t_comp + t_compress) / n_buckets] * n_buckets
    comm = [t_comm_gc / n_buckets] * n_buckets
    return simulate_overlap(t_before, comp, comm)["total"]


def speedup_gc_ovlp(
    P: int,
    t_before: float,
    t_comp: float,
    t_comm: float,
    *,
    volume_ratio: float,
    t_compress: float = 0.0,
    data_dependency: bool = False,
    n_buckets: int = 8,
) -> float:
    """Speedup of a GC scheme under overlapping; ``volume_ratio`` is the
    communication-volume compression factor (dense/sent)."""
    ls = t_before + t_comp
    total = t_gc_ovlp(
        t_before,
        t_comp,
        t_comm / max(volume_ratio, 1e-9),
        t_compress,
        n_buckets=n_buckets,
        data_dependency=data_dependency,
    )
    return P * ls / total


# ---- pack-overhead term (zero-copy arena, DESIGN.md §12) --------------------

def pack_overhead_s(schedule, *, hbm_bw: float, ef: bool = False) -> float:
    """HBM streaming seconds of one phase's arena pack pass.

    The fused ``pack_ef_cast`` pass reads each selected bucket's gradient
    once and writes its wire-dtype arena slot once; with error feedback it
    additionally reads the residual and writes the new one for EVERY
    bucket (unselected buckets update their residual too, and their
    gradient is read for the compensation).  Keeping this term explicit is
    what keeps modeled vs achieved overlap honest: the paper's "near-zero
    compression overhead" is near-zero *because* it is one streaming pass,
    not because it is free.

    Returns 0.0 for leaf-granularity schedules (no arena path).
    """
    plan = schedule.plan
    if plan is None or schedule.granularity != "bucket":
        return 0.0
    total = 0
    seen: set[int] = set()
    for b, call in zip(schedule.selected, schedule.calls):
        if b in seen:
            continue
        seen.add(b)
        bucket = plan.buckets[b]
        total += bucket.nbytes  # read g
        total += bucket.numel * getattr(torch, call.wire_dtype).itemsize  # write wire
    if ef:
        for b, bucket in enumerate(plan.buckets):
            total += 2 * bucket.nbytes  # read r, write r'
            if b not in seen:
                total += bucket.nbytes  # read g for the residual update
    return total / hbm_bw


# ---- schedule-driven timeline (plan/execute split) --------------------------

#: a single scalar bandwidth (every call shares one link — the flat-mesh
#: model) or a per-link mapping like ``{"ici": bw, "dcn": bw}`` matched
#: against each ``CollectiveCall.link`` (hierarchical pods).
LinkBandwidth = Union[float, Mapping[str, float]]


def _bw_for(link_bw: LinkBandwidth, link: str) -> float:
    if isinstance(link_bw, Mapping):
        try:
            return link_bw[link]
        except KeyError:
            raise KeyError(
                f"link_bw mapping has no bandwidth for link {link!r} "
                f"(have {sorted(link_bw)})"
            ) from None
    return link_bw


def schedule_comm_times(
    schedule, *, world: int, link_bw: LinkBandwidth
) -> list[float]:
    """Per-bucket communication times of one phase, aligned with the
    bucket order of the schedule's plan (0.0 for unselected buckets) —
    straight from the static ``CommSchedule``, no tracing or measuring.

    ``link_bw`` may be a per-link mapping (see :data:`LinkBandwidth`);
    each call is then priced at its own link's bandwidth, so a bucket
    carrying calls on two links accumulates both terms."""
    plan = schedule.plan
    if plan is None:
        raise ValueError("schedule carries no BucketPlan")
    times = [0.0] * plan.num_buckets
    if schedule.granularity != "bucket":
        # leaf-granularity schemes have no bucket timeline; spread evenly
        total = sum(
            c.wire_bytes(world) / _bw_for(link_bw, c.link)
            for c in schedule.calls
        )
        return [total / plan.num_buckets] * plan.num_buckets
    if len(schedule.calls) == len(schedule.selected):
        pairs = list(zip(schedule.selected, schedule.calls))
    else:
        # merged hierarchical schedules carry extra pod-level calls beyond
        # the 1:1 selected alignment — recover each call's bucket from its
        # target ("bucket:3" / "pod-bucket:3" / "pod-ag:3")
        pairs = []
        for call in schedule.calls:
            _, _, idx = call.target.rpartition(":")
            pairs.append((int(idx), call))
    for b, call in pairs:
        # += : a bucket may carry several calls (e.g. oktopk route+gather)
        times[b] += call.wire_bytes(world) / _bw_for(link_bw, call.link)
    return times


def simulate_schedule(
    t_before: float,
    t_comp: float,
    schedule,
    *,
    world: int,
    link_bw: LinkBandwidth,
    t_compress: float = 0.0,
    t_pack: float = 0.0,
    data_dependency: bool = False,
    ready_order: bool = False,
) -> dict:
    """Eq (6) with *real* per-bucket volumes from a ``CommSchedule``:
    compute time is spread over buckets proportionally to their numel
    (backward-pass order), communication times come from the planned
    collective bytes.  This is how the trainer's overlap headroom is
    estimated without compiling a step.

    ``ready_order=True`` lays the timeline out in the overlap engine's
    actual issue order (``bucketing.ReadyOrder``: head buckets first,
    embedding last) instead of plan order — the faithful model of the
    fused execution path.

    ``t_pack`` is the arena pack pass (:func:`pack_overhead_s`): like
    ``t_compress`` it rides on the compute lane, spread over buckets
    proportionally — each bucket's slot is packed right before its
    collective can issue.

    Sharded schedules (``schedule.sync == "sharded"``): the per-bucket
    backward timeline carries only the reduce-scatter half
    (``schedule.calls``); the deferred param all-gathers ride the NEXT
    step's forward pass, so they are exposed only to the extent they
    exceed ``t_before`` — the result gains ``deferred_comm`` and folds the
    uncovered remainder into ``exposed_comm``/``total``."""
    plan = schedule.plan
    numels = plan.bucket_numels()
    total = sum(numels) or 1
    comp = [(t_comp + t_compress + t_pack) * n / total for n in numels]
    comm = schedule_comm_times(schedule, world=world, link_bw=link_bw)
    if ready_order and schedule.granularity == "bucket":
        order = build_ready_order(plan).order
        comp = [comp[b] for b in order]
        comm = [comm[b] for b in order]
    if data_dependency:
        t = t_before + sum(comp) + sum(comm)
        sim = {
            "total": t,
            "compute_end": t_before + sum(comp),
            "comm_end": t,
            "bubbles": 0.0,
            "exposed_comm": sum(comm),
            "comm_total": float(sum(comm)),
        }
    else:
        sim = simulate_overlap(t_before, comp, comm)
    if isinstance(link_bw, Mapping):
        t_deferred = sum(
            c.wire_bytes(world) / _bw_for(link_bw, c.link)
            for c in getattr(schedule, "deferred_calls", ())
        )
    else:
        deferred = getattr(schedule, "deferred_wire_bytes", None)
        t_deferred = deferred(world) / link_bw if deferred is not None else 0.0
    if t_deferred > 0.0:
        # the AG half hides under the forward pass (t_before) of the next
        # step; only the uncovered remainder extends the step
        uncovered = max(0.0, t_deferred - t_before)
        sim = dict(sim)
        sim["deferred_comm"] = t_deferred
        sim["exposed_comm"] = sim["exposed_comm"] + uncovered
        sim["comm_total"] = sim["comm_total"] + t_deferred
        sim["total"] = sim["total"] + uncovered
    return sim


def cycle_speedup(
    P: int,
    t_before: float,
    t_comp: float,
    schedules,
    *,
    world: int | None = None,
    link_bw: float,
    t_compress: float = 0.0,
    data_dependency: bool = False,
) -> float:
    """Mean speedup over one full phase cycle (period = num_phases steps),
    each phase simulated with its own planned volumes."""
    schedules = tuple(schedules)
    ls = t_before + t_comp
    totals = [
        simulate_schedule(
            t_before, t_comp, s,
            world=world if world is not None else max(P, 1),
            link_bw=link_bw, t_compress=t_compress,
            data_dependency=data_dependency,
        )["total"]
        for s in schedules
    ]
    mean_total = sum(totals) / max(len(totals), 1)
    return P * ls / mean_total


# ---- measured-trace calibration (adaptive runtime round-trip) ---------------

def calibrate_from_trace(trace: dict) -> dict:
    """Recover the perf model's inputs from a Chrome-trace dict produced by
    ``runtime.trace.TimelineTracer`` — the measured timeline feeding
    back into the same model that planned it.

    Returns mean measured ``t_comp`` / ``t_comm`` / ``ccr`` over the
    trace's probe samples, mean full-step wall time, and — when measured
    comm events carry a ``bytes`` arg — the *effective link bandwidth*
    (bytes moved / aligned seconds).  ``t_comp`` plugs straight into
    :func:`simulate_schedule`; ``link_bw`` replaces the HardwareSpec
    estimate in :func:`schedule_comm_times`.
    """
    if isinstance(trace, dict):
        events = trace.get("traceEvents", [])
    else:
        events = list(trace)   # a bare event list is accepted too

    def spans(kind: str):
        return [
            e for e in events
            if e.get("ph") == "X" and kind in e.get("cat", "").split(",")
        ]

    def mean_dur(evs):
        return sum(e["dur"] for e in evs) / len(evs) / 1e6 if evs else None

    measured = [e for e in spans("measured")]
    comp = [e for e in measured if "compute" in e["cat"].split(",")]
    comm = [e for e in measured if "comm" in e["cat"].split(",")]
    coll = [e for e in measured if "collective" in e["cat"].split(",")]
    steps = [e for e in measured if "step" in e["cat"].split(",")]

    t_comp = mean_dur(comp)
    t_comm = mean_dur(comm)
    out = {
        "t_comp": t_comp,
        "t_comm": t_comm,
        "ccr": (
            t_comm / max(t_comp, 1e-12)
            if t_comp is not None and t_comm is not None
            else None
        ),
        "mean_step_s": mean_dur(steps),
        "num_samples": len(comm),
    }
    with_bytes = [
        e for e in comm + coll
        if e.get("args", {}).get("bytes") and e["dur"] > 0
    ]
    if with_bytes:
        total_bytes = sum(e["args"]["bytes"] for e in with_bytes)
        total_s = sum(e["dur"] for e in with_bytes) / 1e6
        out["link_bw"] = total_bytes / max(total_s, 1e-12)
    return out


@dataclasses.dataclass(frozen=True)
class SchemeProfile:
    """What the timeline model needs to know about a GC scheme."""

    name: str
    volume_ratio: float          # dense bytes / sent bytes
    compress_overhead_frac: float  # T_compress / T_comp
    data_dependency: bool = False
    allgather_based: bool = False  # scales worse with W (Fig. 11)

    def comm_scale(self, world: int) -> float:
        """AllGather traffic grows ~W/(2(W-1)/W) vs ring all-reduce."""
        if not self.allgather_based or world <= 1:
            return 1.0
        ring = 2.0 * (world - 1) / world
        return world / ring
