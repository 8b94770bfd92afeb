"""Device time by the program's own spans (``repro_torch.obs.spans``).

The program's spans are the trace's ``user_annotation`` events whose names
start with ``PREFIXES``; a ``gpu_user_annotation`` (the profiler's copy of
a range on the device's rows) is never device work.  A device operation
belongs to every program span whose interval holds its launch call (the
runtime call that shares its ``correlation``), on the thread that made the
call or on the stepping thread: the stepping thread stays inside
``train/backward`` while the autograd engine's thread launches the
backward pass.  Only operations
launched inside a profiled step count, and a time is the length of the
union of the operations' intervals, in milliseconds a step.
"""
from __future__ import annotations

from collections import defaultdict

from .trace import STEP_SPAN, _end, length

FORWARD = "train/forward"
BACKWARD = "train/backward"
OPTIMIZER = "train/optimizer"
BUCKET_PREFIX = "covap_bucket_"
MOE_DISPATCH = "moe/dispatch"
PREFIXES = ("train/", "moe/", "data/", BUCKET_PREFIX)


def is_program_span(e: dict) -> bool:
    return e.get("cat") == "user_annotation" and e["name"].startswith(PREFIXES)


class Spans:
    """The program's spans of a :class:`~.trace.TraceView` and, for each
    device operation launched inside a profiled step, the names of the
    spans that hold its launch."""

    def __init__(self, view):
        self.view = view
        spans = [e for e in view.spans if is_program_span(e)]
        self.present = {e["name"] for e in spans}
        main = next((e.get("tid") for e in view.spans if e["name"] == STEP_SPAN), None)
        # per thread: (time, order, what); at one instant a span opens
        # before a call it holds and closes after it
        marks: dict = defaultdict(list)
        for e in spans:
            marks[e.get("tid")] += [(e["ts"], 0, e["name"]), (_end(e), 2, e["name"])]
        for c in view.calls:
            corr = c.get("args", {}).get("correlation")
            if corr is None or corr not in view.launch_step:
                continue
            marks[c.get("tid")].append((c["ts"], 1, corr))
            if c.get("tid") != main:
                marks[main].append((c["ts"], 1, corr))
        self.held: dict = defaultdict(set)
        for events in marks.values():
            open_: dict[str, int] = defaultdict(int)
            for _, order, what in sorted(events, key=lambda m: (m[0], m[1])):
                if order == 0:
                    open_[what] += 1
                elif order == 2:
                    open_[what] -= 1
                else:
                    self.held[what].update(n for n, k in open_.items() if k > 0)

    def holding(self, op: dict) -> set[str]:
        """The names of the program spans that hold ``op``'s launch (empty
        when it was launched outside every span or every profiled step)."""
        return self.held.get(op.get("args", {}).get("correlation"), set())

    def ops(self, test) -> list[dict]:
        """The device operations, launched inside the profiled steps, for
        which ``test(names of the spans holding the launch)`` holds."""
        return [op for op in self.view.device if test(self.holding(op))]

    def ms(self, test) -> float:
        """Device ms a step of :meth:`ops` ``(test)``."""
        us = length((op["ts"], _end(op)) for op in self.ops(test))
        return us / 1e3 / self.view.n_steps


def _cached(view) -> Spans:
    spans = getattr(view, "_program_spans", None)
    if spans is None:
        spans = view._program_spans = Spans(view)
    return spans


def span_ms(view, name: str, *, exclude_prefix: str | None = None) -> float | None:
    """Device ms a step of the operations in span ``name`` (and in no span
    whose name starts with ``exclude_prefix``); None when the trace has no
    span of that name or no device operation."""
    sp = _cached(view)
    if name not in sp.present or not view.device:
        return None

    def test(names):
        if name not in names:
            return False
        return exclude_prefix is None or not any(n.startswith(exclude_prefix) for n in names)

    return sp.ms(test)
