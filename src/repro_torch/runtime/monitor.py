"""Online CCR monitor: the measurement half of the adaptive runtime (the
counterpart of ``repro.runtime.monitor``).

The planner picks ``I = ceil(CCR)`` from the *analytic* profiler before a
step runs (``core.ccr.analytic_ccr``).  The paper's adaptive compression
needs the interval to track the CCR the hardware delivers, which drifts
with stragglers, congested links and batch shapes.  This module is the
measurement side of that loop:

* :class:`CCRMonitor`: a ring buffer of step wall times and one of
  comm/compute decompositions, giving a *running measured CCR* (pooled or
  per phase);
* :class:`PhaseProbe`: one decomposition sample, from the trainer's phase
  step timed against the **compute-only** step (the same step built with no
  process group, so every collective is elided) and the **schedule-only**
  program (the dense schedule's collectives on zero buffers), through
  ``core.ccr.measure_ccr``.

The port's step updates the parameters in place, where the reference's
step is a pure function, so the probe runs on clones of the optimizer and
compressor state and puts the parameters back afterwards: the live state is
bitwise what it was.

A probe is a plain callable ``(state, batch, phase) -> PhaseSample``, so
tests can inject synthetic comm slowdowns without touching a clock.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from ..core.ccr import measure_ccr
from ..core.perfmodel import achieved_overlap_fraction
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class PhaseSample:
    """One measured comm/compute decomposition of a phase's step."""

    phase: int
    t_comp: float
    t_comm: float
    step: int = 0
    # wall time of the full step (collectives included); 0.0 on synthetic
    # probes.  t_comp + t_comm - t_full is the communication the step hid
    # this sample (perfmodel.achieved_overlap_fraction).
    t_full: float = 0.0

    @property
    def ccr(self) -> float:
        return self.t_comm / max(self.t_comp, 1e-12)

    @property
    def achieved_overlap(self) -> float | None:
        """Measured overlap fraction, or None when the probe recorded no
        full-step wall time (synthetic probes)."""
        if self.t_full <= 0.0:
            return None
        return achieved_overlap_fraction(self.t_comp, self.t_comm, self.t_full)


class CCRMonitor:
    """Ring buffers of measured step times and CCR decompositions.

    ``record_step`` feeds the cheap signal (a step's wall time, on the
    steps that were timed); ``record_sample`` the occasional expensive one
    (a :class:`PhaseSample` from a probe).  The running measured CCR is the
    mean over the most recent ``window`` samples, per phase when asked,
    pooled otherwise."""

    def __init__(self, window: int = 32):
        self.window = int(window)
        self._steps: collections.deque = collections.deque(maxlen=self.window)
        self._samples: collections.deque = collections.deque(maxlen=self.window)

    # ---- feeding ----------------------------------------------------------
    def record_step(self, step: int, phase: int, wall_s: float) -> None:
        self._steps.append((int(step), int(phase), float(wall_s)))

    def record_sample(self, sample: PhaseSample) -> None:
        self._samples.append(sample)

    def clear_samples(self) -> None:
        """Drop the decomposition window: measurements taken under a plan
        that no longer exists must not drive the next decision."""
        self._samples.clear()

    # ---- reading ----------------------------------------------------------
    @property
    def num_samples(self) -> int:
        return len(self._samples)

    def samples(self, phase: int | None = None) -> list[PhaseSample]:
        if phase is None:
            return list(self._samples)
        return [s for s in self._samples if s.phase == phase]

    def mean_step_time(self, phase: int | None = None) -> float | None:
        ts = [w for (_, p, w) in self._steps if phase is None or p == phase]
        return sum(ts) / len(ts) if ts else None

    def measured_times(self, phase: int | None = None) -> dict | None:
        """Mean ``(t_comp, t_comm)`` over the sample window, or None before
        the first probe.  Samples with a full-step wall time also give
        ``achieved_overlap``, the fraction of the wire time the executed
        step hid under compute."""
        ss = self.samples(phase)
        if not ss:
            return None
        t_comp = sum(s.t_comp for s in ss) / len(ss)
        t_comm = sum(s.t_comm for s in ss) / len(ss)
        out = {"t_comp": t_comp, "t_comm": t_comm,
               "ccr": t_comm / max(t_comp, 1e-12), "n": len(ss)}
        timed = [s for s in ss if s.t_full > 0.0]
        if timed:
            out["t_full"] = sum(s.t_full for s in timed) / len(timed)
            out["achieved_overlap"] = achieved_overlap_fraction(
                sum(s.t_comp for s in timed) / len(timed),
                sum(s.t_comm for s in timed) / len(timed),
                out["t_full"],
            )
        return out

    def measured_ccr(self, phase: int | None = None) -> float | None:
        mt = self.measured_times(phase)
        return None if mt is None else mt["ccr"]

    def summary(self) -> dict:
        """JSON-serialisable digest for logs and ``FitResult``."""
        mt = self.measured_times()
        return {
            "steps_recorded": len(self._steps),
            "probe_samples": len(self._samples),
            "mean_step_s": self.mean_step_time(),
            "measured_ccr": None if mt is None else mt["ccr"],
            "t_comp": None if mt is None else mt["t_comp"],
            "t_comm": None if mt is None else mt["t_comm"],
            "achieved_overlap": None if mt is None else mt.get("achieved_overlap"),
        }


# ---------------------------------------------------------------------------
# the real probe: timing sub-programs against the live trainer
# ---------------------------------------------------------------------------

def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work: ``torch.cuda.synchronize`` on a
    CUDA device, nothing on the CPU (its work is done when the call
    returns)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clone_state(tree):
    """A deep copy of a state tree's tensors (lists, tuples, dicts, ``None``
    holes and Python scalars kept as they are)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_state(v) for v in tree)
    return tree


class PhaseProbe:
    """Measures one phase's comm/compute decomposition on the live state.

    Three sub-programs, built once per plan:

    * **full**: the trainer's own phase step (collectives included);
    * **compute-only**: the same step built with ``group=None``, so no
      collective runs (sharded sync is then the allreduce form);
    * **schedule-only**: the **dense** schedule's collectives on zero
      buffers (every bucket, uncompressed wire).

    ``core.ccr.measure_ccr`` times them.  The comm term is the dense one on
    purpose: the paper's rule ``I = ceil(CCR)`` is defined on the
    uncompressed comm/compute balance.  Timing the compressed step's own
    collectives would divide the measured comm by about ``I``, the
    controller would then pick ``I = 1``, see the dense CCR again and
    oscillate; the dense schedule keeps the measured CCR a property of the
    workload.

    Each call runs the full and compute-only steps on the live parameters
    (the model reads its own) with clones of the optimizer and compressor
    state, and copies the parameters back afterwards; it never touches the
    trainer's pending sharded gather.  Peak memory grows by one copy of the
    parameters, the optimizer state and the residuals, and by the
    schedule-only buffers (one f32 copy of the gradients)."""

    def __init__(self, trainer, *, warmup: int = 1, iters: int = 2):
        self.trainer = trainer
        self.warmup = int(warmup)
        self.iters = int(iters)
        self._compute_only: dict[int, Callable] = {}
        self._comm_only: Callable | None = None
        # the last call's measure_ccr result (t_comm_direct included), with
        # its phase and step
        self.last: dict | None = None

    def invalidate(self) -> None:
        """Drop the sub-programs and the schedule-only buffers (after a
        re-plan)."""
        self._compute_only.clear()
        self._comm_only = None

    # ---- sub-program builders ---------------------------------------------
    def _compute_fn(self, phase: int) -> Callable:
        if phase not in self._compute_only:
            from ..train.trainer import _build_phase_step

            tr = self.trainer
            self._compute_only[phase] = _build_phase_step(
                tr.model, tr.optimizer, tr.compressor, tr.plan, phase=phase,
                group=None, clip_norm=tr.tc.clip_norm,
                fused=tr.tc.overlap == "fused",
            )
        return self._compute_only[phase]

    def _comm_fn(self, device: torch.device) -> Callable:
        # the dense schedule does not depend on the phase; a hierarchical
        # trainer's adds every bucket's two-level cross-pod exchange
        if self._comm_only is None:
            from ..core import get_compressor
            from ..train.trainer import plan_pod_schedule

            tr = self.trainer
            dense = get_compressor("none").plan_phase(tr.plan, 0, world=tr.dp_world)
            pod_group = None
            if tr.hierarchical:
                pods = plan_pod_schedule(tr.plan, pod_phase=0, pod_interval=1,
                                         intra_world=tr.dp_world, n_pods=tr.n_pods)
                dense = dataclasses.replace(dense, calls=dense.calls + pods.calls)
                pod_group = tr.pod_group
            self._comm_only = build_schedule_only_fn(dense, group=tr.group,
                                                     pod_group=pod_group,
                                                     device=device)
        return self._comm_only

    # ---- the probe call ---------------------------------------------------
    def __call__(self, state, batch, phase: int) -> PhaseSample:
        tr = self.trainer
        params = state["params"]
        device = params[0].device
        saved = [p.detach().clone() for p in params]
        probe_state = {"params": params, "opt": clone_state(state["opt"]),
                       "comp": clone_state(state["comp"]), "step": state["step"]}

        def blocked(fn):
            def run():
                fn(probe_state, batch)
                synchronize(device)
            return run

        try:
            res = measure_ccr(
                blocked(tr._phase_fn(phase)),
                blocked(self._compute_fn(phase)),
                step_comm_only=self._comm_fn(device),
                warmup=self.warmup,
                iters=self.iters,
            )
        finally:
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
        self.last = {**res, "phase": int(phase), "step": int(state["step"])}
        return PhaseSample(phase=int(phase), t_comp=res["t_comp"],
                           t_comm=res["t_comm"], step=int(state["step"]),
                           t_full=res["t_full"])


def build_schedule_only_fn(schedule, *, group=None, pod_group=None,
                           device="cuda") -> Callable[[], None]:
    """A program that performs exactly the collectives a ``CommSchedule``
    plans, on zero float32 buffers, one per planned call, so that the wire
    cost of a phase can be timed alone.  It returns after a device
    synchronisation.  A ``"dcn"`` call all-reduces over ``pod_group``,
    every other call over ``group``.  Runs on the GPU unless the caller
    passes ``device="cpu"``.

    With no group the collectives are identities (``b + 0.0``), so the
    measured time is the launch floor: the honest answer on one worker."""
    device = resolve_device(device)
    bufs = [(torch.zeros(max(1, c.payload_bytes // 4), dtype=torch.float32,
                         device=device),
             pod_group if c.link == "dcn" else group)
            for c in schedule.calls]

    def run():
        if not bufs:
            return
        for b, g in bufs:
            if g is not None:
                dist.all_reduce(b, group=g)
            else:
                b + 0.0
        synchronize(device)

    return run


# ---------------------------------------------------------------------------
# synthetic probes (tests) and one-off workload measurement
# ---------------------------------------------------------------------------

def synthetic_probe(t_comp: float, ccr: float | Callable[[int], float]) -> Callable:
    """A probe that reports a prescribed CCR and reads no clock: the
    injected comm slowdown of the tests.  ``ccr`` is a float or a ``step ->
    ccr`` callable (a drifting link)."""

    def probe(state, batch, phase) -> PhaseSample:
        step = int(state["step"]) if isinstance(state, dict) else 0
        c = ccr(step) if callable(ccr) else float(ccr)
        return PhaseSample(phase=int(phase), t_comp=float(t_comp),
                           t_comm=float(t_comp) * c, step=step)

    return probe


def measure_workload_ccr(trainer, state, batch, *, phases: Sequence[int] | None = None,
                         warmup: int = 1, iters: int = 2) -> dict:
    """One-off measured CCR of a trainer's workload: each requested phase
    probed once, the decompositions pooled.  ``api.tune(measured=True)``
    reports it beside the analytic ranking."""
    probe = PhaseProbe(trainer, warmup=warmup, iters=iters)
    todo = list(phases) if phases is not None else list(range(trainer.num_phases))
    mon = CCRMonitor(window=max(len(todo), 8))
    for p in todo:
        mon.record_sample(probe(dict(state), batch, int(p)))
    out = mon.measured_times() or {"t_comp": 0.0, "t_comm": 0.0, "ccr": 0.0}
    out["per_phase"] = {s.phase: s.ccr for s in mon.samples()}
    return out


__all__ = [
    "CCRMonitor",
    "PhaseProbe",
    "PhaseSample",
    "build_schedule_only_fn",
    "clone_state",
    "measure_workload_ccr",
    "synchronize",
    "synthetic_probe",
]
