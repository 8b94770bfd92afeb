"""Timeline tracing: planned-vs-measured step timelines as Chrome trace JSON
(the counterpart of ``repro.runtime.trace``, the same events).

Open the dump in ``chrome://tracing`` / Perfetto: one process row per view —

* ``planned``  — per-bucket compute/comm spans from the static
  ``CommSchedule`` + the analytic step times (what the planner *promised*);
* ``measured`` — full-step wall times from the monitor's ring buffer and
  the probe's comm/compute decompositions (what the hardware *delivered*);
* ``control``  — instant events marking re-plans;
* ``serve``    — per-request serving spans (queued → prefill → insert →
  decode, one Chrome-trace thread per request) plus queue-depth /
  page-pool counter tracks from the engine.

The measured events carry enough in ``args`` (bytes, phase) that the trace
round-trips into the perf model: ``core.perfmodel.calibrate_from_trace``
recovers mean ``t_comp`` / ``t_comm`` / effective link bandwidth from a
trace dict, which plug straight into ``simulate_schedule`` — measurements
calibrate the same model that produced the plan.

Multi-worker timestamps go through ``core.ccr.align_comm_times`` before
becoming spans, so rendezvous wait is excluded exactly as in the paper's
distributed profiler (§III.B, Fig. 3).
"""
from __future__ import annotations

import collections
import json
from typing import Any, Sequence

import numpy as np

from ..core.ccr import align_comm_times
from ..core.perfmodel import schedule_comm_times

# Chrome trace pids: one logical process per view
PID_PLANNED = 1
PID_MEASURED = 2
PID_CONTROL = 3
PID_SERVE = 4

_US = 1e6


class TimelineTracer:
    """Collects trace events; ``to_chrome_trace()`` / ``save()`` export.

    ``max_events`` bounds host memory on long runs (paper-scale training
    is O(10^5) steps): the buffer is a ring, oldest spans fall off first —
    the same windowing discipline as the monitor's ring buffers."""

    def __init__(self, max_events: int = 100_000):
        self.events: collections.deque[dict] = collections.deque(
            maxlen=int(max_events)
        )
        self._cursor_s = 0.0       # synthetic wall clock of measured steps

    # ---- low-level --------------------------------------------------------
    def add_event(
        self, name: str, *, pid: int, tid: int, ts_s: float, dur_s: float,
        cat: str = "", args: dict | None = None, ph: str = "X",
    ) -> None:
        ev = {
            "name": name, "ph": ph, "pid": pid, "tid": tid,
            "ts": ts_s * _US, "cat": cat,
        }
        if ph == "X":
            ev["dur"] = dur_s * _US
        if args:
            ev["args"] = args
        self.events.append(ev)

    # ---- measured view ----------------------------------------------------
    def record_step(self, step: int, phase: int, wall_s: float) -> None:
        """One full training step (ring-buffer signal)."""
        self.add_event(
            f"step {step}", pid=PID_MEASURED, tid=0,
            ts_s=self._cursor_s, dur_s=wall_s, cat="measured,step",
            args={"step": step, "phase": phase},
        )
        self._cursor_s += wall_s

    def record_sample(self, sample, *, bytes_on_wire: int | None = None) -> None:
        """One probe decomposition: back-to-back compute + comm spans.
        ``bytes_on_wire`` (the phase schedule's planned wire bytes) makes
        the comm span calibratable into an effective link bandwidth."""
        t0 = self._cursor_s
        self.add_event(
            "compute", pid=PID_MEASURED, tid=1, ts_s=t0,
            dur_s=sample.t_comp, cat="measured,compute",
            args={"step": sample.step, "phase": sample.phase},
        )
        comm_args: dict[str, Any] = {"step": sample.step, "phase": sample.phase}
        if bytes_on_wire is not None:
            comm_args["bytes"] = int(bytes_on_wire)
        self.add_event(
            "comm", pid=PID_MEASURED, tid=1, ts_s=t0 + sample.t_comp,
            dur_s=sample.t_comm, cat="measured,comm", args=comm_args,
        )

    def record_aligned_collectives(
        self,
        step: int,
        names: Sequence[str],
        starts: np.ndarray,
        ends: np.ndarray,
        *,
        bytes_per_op: Sequence[int] | None = None,
    ) -> None:
        """Per-collective spans from (workers, ops) timestamp arrays, with
        the paper's alignment applied: span start is the **last** worker's
        arrival, duration the aligned transfer time."""
        starts = np.asarray(starts, np.float64)
        ends = np.asarray(ends, np.float64)
        durs = align_comm_times(starts, ends)
        t_start = starts.max(axis=0)
        for i, name in enumerate(names):
            args = {"step": step, "op": i}
            if bytes_per_op is not None:
                args["bytes"] = int(bytes_per_op[i])
            self.add_event(
                name, pid=PID_MEASURED, tid=2,
                ts_s=float(t_start[i]), dur_s=float(max(durs[i], 0.0)),
                cat="measured,collective", args=args,
            )

    # ---- planned view -----------------------------------------------------
    def record_planned_phase(
        self, schedule, *, t_before: float, t_comp: float,
        link_bw: float, world: int, at_s: float = 0.0,
    ) -> None:
        """The planner's promised timeline for one phase: the same
        simulation the perf model runs (``simulate_schedule``), emitted as
        spans instead of a scalar."""
        plan = schedule.plan
        numels = plan.bucket_numels()
        total = sum(numels) or 1
        comp = [t_comp * n / total for n in numels]
        comm = schedule_comm_times(schedule, world=world, link_bw=link_bw)

        self.add_event(
            "before", pid=PID_PLANNED, tid=0, ts_s=at_s, dur_s=t_before,
            cat="planned,compute", args={"phase": schedule.phase},
        )
        t = at_s + t_before
        comm_free = t
        for b, (c_comp, c_comm) in enumerate(zip(comp, comm)):
            self.add_event(
                f"bwd bucket {b}", pid=PID_PLANNED, tid=0, ts_s=t,
                dur_s=c_comp, cat="planned,compute",
                args={"phase": schedule.phase, "bucket": b},
            )
            t += c_comp
            if c_comm > 0:
                start = max(t, comm_free)
                # bytes = ring-amplified wire bytes, the same convention
                # the measured comm spans use, so planned and measured
                # rows divide to the same effective bandwidth.  `selected`
                # holds bucket ids only at bucket granularity; leaf-
                # granularity schedules spread their comm evenly over the
                # buckets (matching schedule_comm_times), so the bytes
                # spread the same way
                if schedule.granularity == "bucket":
                    span_bytes = sum(
                        call.wire_bytes(world)
                        for s, call in zip(schedule.selected, schedule.calls)
                        if s == b
                    )
                else:
                    span_bytes = schedule.wire_bytes(world) / max(
                        plan.num_buckets, 1
                    )
                self.add_event(
                    f"comm bucket {b}", pid=PID_PLANNED, tid=1, ts_s=start,
                    dur_s=c_comm, cat="planned,comm",
                    args={
                        "phase": schedule.phase, "bucket": b,
                        "bytes": int(round(span_bytes)),
                    },
                )
                comm_free = start + c_comm

    def record_planned_buckets(
        self, schedule, *, world: int | None = None,
        link_bw: float | None = None, at_s: float = 0.0,
    ) -> None:
        """One named span per collective issue of a phase, in the exact
        order the overlap engine fires them (``CommSchedule.issue_order()``)
        — the per-bucket resolution the phase-level planned view lacks.

        Spans are laid back-to-back on their own planned thread; with a
        ``link_bw`` each span's duration is the call's ring transfer time,
        otherwise spans get a nominal unit width (ordering and naming are
        the payload, not the absolute timescale).  ``args`` carry phase /
        bucket / op / bytes so the smoke gate (and Perfetto queries) can
        count distinct buckets against ``plan.num_buckets``."""
        w = world if world is not None else schedule.world
        t = at_s
        for rank, i in enumerate(schedule.issue_order()):
            call = schedule.calls[i]
            sel = int(schedule.selected[i])
            span_bytes = call.wire_bytes(w)
            dur = span_bytes / link_bw if link_bw else 1e-6
            label = "bucket" if schedule.granularity == "bucket" else "leaf"
            self.add_event(
                f"issue {label} {sel} ({call.op})",
                pid=PID_PLANNED, tid=2, ts_s=t, dur_s=dur,
                cat="planned,issue",
                args={
                    "phase": schedule.phase, label: sel, "op": call.op,
                    "bytes": int(round(span_bytes)), "rank": rank,
                },
            )
            t += dur

    # ---- control view -----------------------------------------------------
    def record_replan(
        self, step: int, old_interval: int, new_interval: int, reason: str
    ) -> None:
        self.add_event(
            f"replan I {old_interval}->{new_interval}",
            pid=PID_CONTROL, tid=0, ts_s=self._cursor_s, dur_s=0.0,
            cat="control,replan", ph="i",
            args={"step": step, "old": old_interval, "new": new_interval,
                  "reason": reason},
        )

    # ---- serve view -------------------------------------------------------
    def record_request(self, comp, *, t0: float = 0.0) -> None:
        """Per-request lifecycle spans from a serve ``Completion``: one
        Chrome-trace thread per request id, with ``queued`` (submit →
        admit), ``prefill`` (admit → prefill end), ``insert`` (prefill end
        → first token), and ``decode`` (first token → finish) laid
        end-to-end.  ``t0`` rebases wall-clock stamps so traces start near
        zero.  Requests truncated before prefill (no first token) get only
        their queued span — there are no stages to show."""
        tid = int(comp.rid)
        args = {
            "rid": int(comp.rid),
            "prompt_len": int(comp.prompt_len),
            "new_tokens": len(comp.tokens),
            "finish_reason": comp.finish_reason,
        }
        admit = comp.admit_s if comp.admit_s is not None else comp.finish_s
        self.add_event(
            f"queued r{comp.rid}", pid=PID_SERVE, tid=tid,
            ts_s=comp.submit_s - t0, dur_s=max(admit - comp.submit_s, 0.0),
            cat="serve,queued", args=args,
        )
        if comp.admit_s is None or comp.first_token_s is None:
            return
        prefill_end = (
            comp.prefill_end_s
            if getattr(comp, "prefill_end_s", None) is not None
            else comp.first_token_s
        )
        stages = (
            ("prefill", comp.admit_s, prefill_end),
            ("insert", prefill_end, comp.first_token_s),
            ("decode", comp.first_token_s, comp.finish_s),
        )
        for stage, start, end in stages:
            self.add_event(
                f"{stage} r{comp.rid}", pid=PID_SERVE, tid=tid,
                ts_s=start - t0, dur_s=max(end - start, 0.0),
                cat=f"serve,{stage}", args=args,
            )

    def record_counter(
        self, name: str, ts_s: float, values: dict, *, pid: int = PID_SERVE
    ) -> None:
        """Chrome counter sample (``ph: "C"``) — queue depth, page-pool
        occupancy, active slots render as stacked area tracks."""
        self.events.append({
            "name": name, "ph": "C", "pid": pid, "tid": 0,
            "ts": ts_s * _US,
            "args": {k: float(v) for k, v in values.items()},
        })

    # ---- export -----------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        meta = [
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": label}}
            for pid, label in (
                (PID_PLANNED, "planned"),
                (PID_MEASURED, "measured"),
                (PID_CONTROL, "control"),
                (PID_SERVE, "serve"),
            )
        ]
        return {
            "traceEvents": meta + list(self.events),
            "displayTimeUnit": "ms",
        }

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


__all__ = [
    "TimelineTracer",
    "PID_PLANNED",
    "PID_MEASURED",
    "PID_CONTROL",
    "PID_SERVE",
]
