"""The telemetry bundle: one handle over the three views (the counterpart
of ``repro.obs.telemetry``).

A :class:`Telemetry` owns a :class:`~.registry.MetricsRegistry` (how much,
how fast), an :class:`~.events.EventLog` (why) and a
:class:`~repro_torch.runtime.trace.TimelineTracer` (when), so that the
trainer and the adaptive runtime write into the same sinks and ``save()``
drops one telemetry directory:

* ``metrics.prom``: the registry's Prometheus textfile exposition;
* ``metrics.json``: the flat ``snapshot()`` dict;
* ``events.jsonl``: streamed as events happen (crash-safe), schema-valid;
* ``trace.json``: a Chrome trace with planned, measured and control rows,
  openable in Perfetto.

``as_telemetry`` is the coercion every entry point (``Trainer.run``,
``api.fit``, ``api.tune``, the CLI) routes through: ``None`` gives the
shared disabled singleton (near-zero cost), a path string a
directory-backed bundle, an existing bundle itself.
"""
from __future__ import annotations

import json
import os

from .events import NULL_EVENTS, EventLog
from .registry import NULL_REGISTRY, MetricsRegistry
from ..runtime.trace import TimelineTracer


class Telemetry:
    """Bundle of registry + event log + tracer sharing one run identity.

    ``directory=None`` keeps everything in memory (events buffer in
    ``events.records``; ``save(path)`` can still export later).  With a
    directory, events stream to ``events.jsonl`` immediately and
    ``save()`` writes the remaining artifacts there.
    """

    def __init__(
        self,
        directory: str | None = None,
        *,
        enabled: bool = True,
        run_id: str | None = None,
        max_trace_events: int = 100_000,
        hist_window: int = 1024,
    ):
        self.enabled = bool(enabled)
        self.directory = directory
        if self.enabled and directory is not None:
            os.makedirs(directory, exist_ok=True)
        events_path = (
            os.path.join(directory, "events.jsonl")
            if (self.enabled and directory is not None)
            else None
        )
        self.registry = MetricsRegistry(
            enabled=self.enabled, hist_window=hist_window
        )
        self.events = EventLog(
            events_path, run_id=run_id, enabled=self.enabled
        )
        self.tracer = TimelineTracer(max_events=max_trace_events)
        self._manifest_done = False

    # Manifest is once-per-bundle: chunked launcher loops call
    # ``Trainer.run`` repeatedly against the same telemetry handle.
    def manifest_once(self, **fields) -> bool:
        if not self.enabled or self._manifest_done:
            return False
        self.events.emit("manifest", **fields)
        self._manifest_done = True
        return True

    def save(self, directory: str | None = None) -> dict | None:
        """Write ``metrics.prom`` / ``metrics.json`` / ``trace.json`` (and,
        for memory-backed bundles, ``events.jsonl``) into ``directory``
        (default: the bundle's own).  Returns ``{artifact: path}``."""
        if not self.enabled:
            return None
        directory = directory or self.directory
        if directory is None:
            raise ValueError("telemetry has no directory; pass one to save()")
        os.makedirs(directory, exist_ok=True)
        paths = {}
        prom = os.path.join(directory, "metrics.prom")
        with open(prom, "w") as f:
            f.write(self.registry.to_prometheus_text())
        paths["prom"] = prom
        snap = os.path.join(directory, "metrics.json")
        with open(snap, "w") as f:
            json.dump(self.registry.snapshot(), f, indent=1, sort_keys=True)
        paths["snapshot"] = snap
        trace = os.path.join(directory, "trace.json")
        self.tracer.save(trace)
        paths["trace"] = trace
        events = os.path.join(directory, "events.jsonl")
        if self.events.path is None and self.events.records:
            with open(events, "w") as f:
                for rec in self.events.records:
                    f.write(json.dumps(rec) + "\n")
            paths["events"] = events
        elif self.events.path is not None:
            paths["events"] = self.events.path
        return paths

    def close(self) -> None:
        self.events.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


NULL_TELEMETRY = Telemetry(enabled=False)


def as_telemetry(obj) -> Telemetry:
    """Coerce the user-facing ``telemetry=`` argument to a bundle:
    ``None`` → shared disabled singleton, ``str`` path → directory-backed
    bundle, ``Telemetry`` → itself."""
    if obj is None:
        return NULL_TELEMETRY
    if isinstance(obj, Telemetry):
        return obj
    if isinstance(obj, str):
        return Telemetry(obj)
    raise TypeError(
        f"telemetry must be None, a directory path, or a Telemetry bundle; "
        f"got {type(obj).__name__}"
    )


__all__ = ["NULL_TELEMETRY", "Telemetry", "as_telemetry"]
