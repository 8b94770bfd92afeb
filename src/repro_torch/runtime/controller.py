"""Re-planning controller: measured CCR in, fresh plans out (the
counterpart of ``repro.runtime.controller``).

The decision rule is the paper's ``I = ceil(CCR)`` applied to the
*measured* CCR of :class:`~.monitor.CCRMonitor`, inside a hysteresis band
so that transient stragglers do not thrash the step functions:

* the current interval ``I`` is *consistent* with any measured CCR in
  ``(I - 1 - h, I + h]`` (``h`` = ``hysteresis``): ``ceil`` would pick
  ``I`` for the un-widened band, and ``h`` widens it on both sides;
* a re-plan needs ``patience`` consecutive out-of-band decisions, at
  least ``cooldown_steps`` since the previous re-plan, and fewer than
  ``max_replans`` switches so far;
* the new interval is ``select_interval(measured_ccr)``: one hop puts the
  interval within ±1 of ``ceil(measured CCR)``.

:class:`AdaptiveRuntime` glues monitor → controller → transitions → trace
around a live :class:`~repro_torch.train.trainer.Trainer`; the trainer
calls ``after_step`` once a step.  With a process group of several ranks,
each rank runs its own runtime and times its own probe; the runtime takes
the maximum of every sample's times over the group before the controller
sees it, so every rank makes the same decisions at the same steps (the
reference's one controller for all devices).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from ..core.ccr import HardwareSpec, allreduce_bytes_on_wire, select_interval
from ..core.comm import dense_bytes
from .monitor import CCRMonitor, PhaseProbe, PhaseSample
from .trace import TimelineTracer


@dataclasses.dataclass(frozen=True)
class AutotuneConfig:
    """Knobs of the adaptive runtime (``Trainer.run(autotune=...)``)."""

    measure_every: int = 16      # steps between probe measurements
    warmup_steps: int = 4        # steps before the first probe (compile noise)
    window: int = 8              # probe samples pooled per decision
    hysteresis: float = 0.25     # CCR deadband beyond the ceil boundaries
    patience: int = 2            # consecutive drifting decisions to re-plan
    cooldown_steps: int = 32     # min steps between re-plans
    max_replans: int = 8
    max_interval: int = 64
    # circuit breaker: when the measured CCR oscillates across a band
    # boundary (straggler flapping, noisy probes, or an injected ccr_skew
    # fault), hysteresis+patience damp the thrash but cannot stop a slow
    # alternation that re-plans every cooldown.  The breaker latches the
    # controller OPEN (interval frozen, decisions keep flowing with reason
    # "circuit-open:...") after breaker_replans re-plans land within any
    # breaker_window_steps span.
    # 0 disables.  Latched is latched: only an explicit reset_breaker()
    # (an operator action) closes it again.
    breaker_replans: int = 4
    breaker_window_steps: int = 256
    transition_policy: str = "carry"   # "carry" | "rescale" | "flush"
    probe: Callable[..., PhaseSample] | None = None  # override (tests/bench)
    probe_warmup: int = 1
    probe_iters: int = 2
    trace_path: str | None = None      # Chrome-trace JSON dump on finish


@dataclasses.dataclass(frozen=True)
class ReplanDecision:
    replan: bool
    interval: int                # target interval (== current when not replan)
    measured_ccr: float | None
    reason: str


class ReplanController:
    """Hysteresis policy over the monitor's running measured CCR.

    ``exposed_scale`` re-prices the measured CCR for the sync mode's
    *exposed* communication (sharded sync): the probe's
    comm term reflects the dense all-reduce volume, but under
    ``sync="sharded"`` only the reduce-scatter half — ``(W-1)/W`` of the
    buffer vs the all-reduce's ``2(W-1)/W``, i.e. exactly half — must hide
    behind the backward pass (the param all-gather rides the next
    forward).  The interval rule ``I = ceil(CCR)`` therefore applies to
    ``measured_ccr * exposed_scale``; with the default 1.0 the behaviour
    is unchanged."""

    def __init__(
        self, config: AutotuneConfig, *, interval: int,
        exposed_scale: float = 1.0,
    ):
        self.config = config
        self.interval = int(interval)
        self.exposed_scale = float(exposed_scale)
        self.pending = 0
        self.replans = 0
        self.last_replan_step = -(10 ** 9)
        self.decisions: list[ReplanDecision] = []
        self.replan_steps: list[int] = []
        self.frozen = False
        self.freeze_reason: str | None = None

    # ---- circuit breaker --------------------------------------------------
    def freeze(self, reason: str) -> None:
        """Latch the breaker open: the interval is frozen and every
        subsequent decision is a no-replan with reason
        ``"circuit-open:<reason>"``."""
        self.frozen = True
        self.freeze_reason = reason

    def reset_breaker(self) -> None:
        """Close a latched breaker (operator action): re-plan history is
        kept, but the window that tripped it is cleared so the very next
        re-plan cannot instantly re-latch."""
        self.frozen = False
        self.freeze_reason = None
        self.replan_steps.clear()

    def _check_breaker(self, step: int) -> None:
        c = self.config
        if c.breaker_replans <= 0 or self.frozen:
            return
        recent = [
            s for s in self.replan_steps
            if step - s < c.breaker_window_steps
        ]
        if len(recent) >= c.breaker_replans:
            self.freeze(
                f"{len(recent)} replans in {c.breaker_window_steps} steps"
            )

    # ---- the band ---------------------------------------------------------
    def consistent(self, ccr: float) -> bool:
        """Is the current interval still the right pick for this
        (already exposure-scaled) CCR?"""
        h = self.config.hysteresis
        lo = self.interval - 1 - h
        hi = self.interval + h
        return lo < ccr <= hi

    # ---- one decision -----------------------------------------------------
    def observe(self, step: int, measured_ccr: float | None) -> ReplanDecision:
        c = self.config

        def out(replan, interval, reason):
            d = ReplanDecision(replan, interval, measured_ccr, reason)
            self.decisions.append(d)
            if replan:
                self.pending = 0
                self.replans += 1
                self.last_replan_step = int(step)
                self.interval = int(interval)
                self.replan_steps.append(int(step))
                # latch AFTER the commit: the replan that trips the
                # breaker still lands (so max_replans stays the hard
                # bound); everything later is frozen out
                self._check_breaker(int(step))
            return d

        if self.frozen:
            return out(False, self.interval,
                       f"circuit-open:{self.freeze_reason}")
        if measured_ccr is None:
            return out(False, self.interval, "no-measurement")
        effective_ccr = measured_ccr * self.exposed_scale
        if self.consistent(effective_ccr):
            self.pending = 0
            return out(False, self.interval, "in-band")
        target = select_interval(effective_ccr, c.max_interval)
        if target == self.interval:
            # out of the widened band but ceil still agrees (h < drift < 1)
            self.pending = 0
            return out(False, self.interval, "ceil-agrees")
        self.pending += 1
        if self.pending < c.patience:
            return out(False, self.interval, f"pending {self.pending}/{c.patience}")
        if step - self.last_replan_step < c.cooldown_steps:
            return out(False, self.interval, "cooldown")
        if self.replans >= c.max_replans:
            return out(False, self.interval, "max-replans")
        return out(True, target, f"ccr {effective_ccr:.2f} -> I {target}")


class AdaptiveRuntime:
    """monitor → controller → transitions → trace, around one Trainer.

    The trainer owns the loop; this object owns everything adaptive.  One
    call a step::

        state = runtime.after_step(state, batch, wall_s=dt)

    may re-plan the trainer (new compressor, plan and step functions) and
    returns the (possibly transitioned) train state.
    """

    def __init__(self, trainer, config: AutotuneConfig | None = None):
        self.trainer = trainer
        self.config = config or AutotuneConfig()
        self.monitor = CCRMonitor(window=self.config.window)
        self.controller = ReplanController(
            self.config, interval=trainer.tc.interval,
            exposed_scale=exposed_comm_scale(trainer),
        )
        self.tracer = TimelineTracer()
        self._default_probe = (
            None if self.config.probe is not None
            else PhaseProbe(trainer, warmup=self.config.probe_warmup,
                            iters=self.config.probe_iters)
        )
        self.transitions: list = []
        self._step_count = 0
        self._probe_count = 0
        self._planned_key = None
        self._events = None          # the obs EventLog once telemetry is attached

    @property
    def phase_probe(self) -> PhaseProbe | None:
        """The real probe, or None when ``config.probe`` replaces it; its
        ``last`` holds the last call's ``measure_ccr`` result."""
        return self._default_probe

    def attach_telemetry(self, telemetry) -> None:
        """Route this runtime through a :class:`repro_torch.obs.Telemetry`
        bundle: planned, measured and control spans land in the bundle's
        tracer, and every probe and controller decision goes to its event
        log, the audit trail of each ``I`` switch.  Events already traced
        are carried over, so that an attach mid-training loses nothing.
        Attaching the bundle the runtime already writes to (each chunk of a
        checkpoint-every loop does) changes nothing."""
        if not telemetry.enabled or self.tracer is telemetry.tracer:
            return
        for ev in self.tracer.events:
            telemetry.tracer.events.append(ev)
        telemetry.tracer._cursor_s = max(telemetry.tracer._cursor_s,
                                         self.tracer._cursor_s)
        self.tracer = telemetry.tracer
        self._events = telemetry.events

    # ---- probing ----------------------------------------------------------
    def _probe(self, state, batch, phase: int) -> PhaseSample:
        if self.config.probe is not None:
            return self.config.probe(state, batch, phase)
        return self._default_probe(state, batch, phase)

    def _agree(self, sample: PhaseSample, device: torch.device) -> PhaseSample:
        """The sample every rank of the trainer's group sees: each of
        ``t_full``, ``t_comp`` and ``t_comm`` at its maximum over the group,
        so that the slowest rank sets the pace and every rank's controller
        makes the same decision (every pod's too: the world group of a
        hierarchical trainer).  Without a group the sample is unchanged."""
        group = self.trainer.world_group
        if group is None:
            return sample
        t = torch.tensor([sample.t_full, sample.t_comp, sample.t_comm],
                         dtype=torch.float64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        t_full, t_comp, t_comm = t.tolist()
        return dataclasses.replace(sample, t_full=t_full, t_comp=t_comp,
                                   t_comm=t_comm)

    def _due(self, i: int) -> bool:
        c = self.config
        if i < c.warmup_steps:
            return False
        return (i - c.warmup_steps) % max(c.measure_every, 1) == 0

    def due_next(self) -> bool:
        """Will the NEXT ``after_step`` call probe?  The trainer waits for
        the device (for a meaningful wall time) only then: a wait on every
        step would stop the host from running ahead of the device on every
        step to feed a diagnostic metric."""
        return self._due(self._step_count)

    # ---- the per-step hook -------------------------------------------------
    def after_step(self, state, batch, *, wall_s: float | None, log=None):
        tr = self.trainer
        step = int(state["step"]) - 1       # the step that just ran
        phase = step % tr.num_phases
        if wall_s is not None:
            self.monitor.record_step(step, phase, wall_s)
            self.tracer.record_step(step, phase, wall_s)
        i = self._step_count
        self._step_count += 1
        if not self._due(i):
            return state

        # probe the phases round-robin, not the phase the step landed on:
        # with num_phases | measure_every the step's phase is constant, and
        # always sampling one phase would bias the pooled CCR
        probe_phase = self._probe_count % max(tr.num_phases, 1)
        self._probe_count += 1
        sample = self._agree(self._probe(state, batch, probe_phase),
                             state["params"][0].device)
        self.monitor.record_sample(sample)
        # the probe's comm term is the DENSE schedule's (see PhaseProbe), so
        # the calibration bytes are the dense ring-amplified wire bytes
        wire = allreduce_bytes_on_wire(dense_bytes(tr.plan), tr.dp_world)
        self.tracer.record_sample(sample, bytes_on_wire=int(round(wire)))
        measured = self.monitor.measured_ccr()
        decision = self.controller.observe(step, measured)
        if self._events is not None:
            self._events.emit(
                "probe",
                step=int(sample.step), phase=int(sample.phase),
                t_comp=float(sample.t_comp), t_comm=float(sample.t_comm),
                ccr=float(sample.ccr),
                achieved_overlap=(float(sample.achieved_overlap)
                                  if sample.achieved_overlap is not None else None),
            )
            self._events.emit(
                "replan_decision",
                step=int(step),
                interval=int(decision.interval),
                replan=bool(decision.replan),
                reason=decision.reason,
                measured_ccr=float(measured) if measured is not None else None,
                effective_ccr=(float(measured * self.controller.exposed_scale)
                               if measured is not None else None),
                exposed_scale=self.controller.exposed_scale,
                pending=int(self.controller.pending),
            )
        if not decision.replan:
            return state

        old_interval = tr.tc.interval
        state, report = tr.replan(decision.interval, state,
                                  policy=self.config.transition_policy, step=step)
        self.transitions.append(report)
        # measurements of the old plan must not drive decisions on the new
        # one: drop the sample window and the probe's sub-programs
        self.monitor.clear_samples()
        self._probe_count = 0
        if self._default_probe is not None:
            self._default_probe.invalidate()
        self.tracer.record_replan(step, old_interval, decision.interval,
                                  decision.reason)
        if self._events is not None:
            self._events.emit(
                "replan",
                step=int(step),
                old_interval=int(old_interval),
                new_interval=int(decision.interval),
                reason=decision.reason,
                policy=report.policy,
                residual_norm_before=float(report.norm_before),
                residual_norm_after=float(report.norm_after),
            )
        if log:
            log(f"[autotune] step {step}: measured CCR "
                f"{decision.measured_ccr:.2f} -> re-plan I={decision.interval}"
                f" (residual norm {report.norm_before:.3e} -> "
                f"{report.norm_after:.3e}, {report.policy})")
        return state

    # ---- wrap-up -----------------------------------------------------------
    def _record_planned(self) -> None:
        """Trace the planner's timeline of the final plan, priced with the
        *measured* calibration (measured ``t_comp``; link bandwidth =
        planned wire bytes / measured comm seconds), so that the planned
        and measured rows of the trace compare directly.  When the measured
        comm is about 0 (one worker), the paper's environment's link
        (``HardwareSpec.cloud_v100_30gbps``) prices the planned spans."""
        mt = self.monitor.measured_times()
        if mt is None:
            return
        tr = self.trainer
        key = (tr.tc.interval, tr.num_phases)
        if self._planned_key == key:
            return     # chunked runs call finish() repeatedly: record once
        self._planned_key = key
        scheds = tr.schedules()
        mean_wire = sum(s.wire_bytes(tr.dp_world) for s in scheds) / max(len(scheds), 1)
        if mt["t_comm"] > 1e-9 and mean_wire > 0:
            link_bw = mean_wire / mt["t_comm"]
        else:
            link_bw = HardwareSpec.cloud_v100_30gbps().ici_bw
        at = 0.0
        for s in scheds:
            self.tracer.record_planned_phase(
                s, t_before=mt["t_comp"] * 0.5, t_comp=mt["t_comp"],
                link_bw=link_bw, world=tr.dp_world, at_s=at,
            )
            # one named span per collective issue of this phase, in the
            # order the fused overlap issues them
            self.tracer.record_planned_buckets(s, world=tr.dp_world,
                                               link_bw=link_bw, at_s=at)
            at += mt["t_comp"] * 1.5 + s.wire_bytes(tr.dp_world) / link_bw

    def finish(self) -> dict:
        self._record_planned()
        if self.config.trace_path:
            self.tracer.save(self.config.trace_path)
        return self.summary()

    def summary(self) -> dict:
        return {
            "interval": self.controller.interval,
            "replans": self.controller.replans,
            "breaker_open": self.controller.frozen,
            "breaker_reason": self.controller.freeze_reason,
            "measured_ccr": self.monitor.measured_ccr(),
            "monitor": self.monitor.summary(),
            "transitions": [t.summary() for t in self.transitions],
            "trace_events": len(self.tracer.events),
        }


def exposed_comm_scale(trainer, hw: HardwareSpec | None = None) -> float:
    """The fraction of the probe's (dense all-reduce) comm term that stays
    *exposed* behind the backward pass under the trainer's sync mode, from
    the static per-link ``CommSchedule`` accounting.

    ``allreduce``: all of it, 1.0.  ``sharded``: per phase, the slowest
    link's exposed wire bytes over that link's bandwidth (the intra-pod
    reduce-scatters and, with hierarchical pods, the cross-pod shard
    exchange), against the all-reduce equivalent of the same payloads on
    the fast link, which is what the probe's dense comm term measures.  On a
    flat plan this is exactly 0.5: a reduce-scatter moves ``(W-1)/W`` of the
    buffer where the all-reduce moves ``2(W-1)/W``, and the param all-gather
    is deferred under the next forward pass.  Pods raise it by the exposed
    cross-pod exchange.  A single-worker trainer keeps 1.0: there is no
    collective to halve.

    ``hw`` (default :meth:`HardwareSpec.cloud_v100_30gbps`) supplies the
    per-link bandwidths ``{"ici", "dcn"}``."""
    if getattr(trainer.tc, "sync", "allreduce") != "sharded":
        return 1.0
    if trainer.dp_world <= 1:
        return 1.0
    hw = hw or HardwareSpec.cloud_v100_30gbps()
    bw = {"ici": hw.ici_bw, "dcn": hw.dcn_bw}
    num = 0.0
    den = 0.0
    for s in trainer.schedules():
        by_link = s.exposed_wire_bytes_by_link(trainer.dp_world)
        num += max((v / bw[l] for l, v in by_link.items()), default=0.0)
        for c in s.calls:
            wire = c.wire_bytes(trainer.dp_world)
            # all-reduce equivalent: a reduce-scatter (or all-gather) half
            # moves exactly half of what the ring all-reduce would
            if c.op in ("reduce_scatter", "all_gather"):
                wire *= 2.0
            den += wire / hw.ici_bw
    if den <= 0.0:
        return 1.0
    return min(1.0, num / den)


def as_autotune_config(autotune) -> AutotuneConfig | None:
    """Normalise ``Trainer.run(autotune=...)``: None/False off, True the
    defaults, an :class:`AutotuneConfig` passes through."""
    if autotune is None or autotune is False:
        return None
    if autotune is True:
        return AutotuneConfig()
    if isinstance(autotune, AutotuneConfig):
        return autotune
    raise TypeError(f"autotune must be None/bool/AutotuneConfig, got {autotune!r}")


__all__ = [
    "AdaptiveRuntime",
    "AutotuneConfig",
    "ReplanController",
    "ReplanDecision",
    "as_autotune_config",
    "exposed_comm_scale",
]
