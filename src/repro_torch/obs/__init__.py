"""Telemetry: metrics registry, structured event log, span tracing (the
counterpart of ``repro.obs``).

Three views of one run:

* :class:`MetricsRegistry`: labeled counters, gauges and histograms;
  ``snapshot()`` gives a flat dict and ``to_prometheus_text()`` the
  scrape-side exposition.
* :class:`EventLog`: an append-only JSONL narrative (manifest, steps,
  probes, the audit trail of re-plan decisions), validated at emit time
  against ``event_schema.json``, the port's copy of the reference's.
* :class:`~repro_torch.runtime.trace.TimelineTracer`: Chrome-trace spans
  (planned per-bucket timelines, measured decompositions, control marks)
  in one Perfetto-openable file.

:class:`Telemetry` bundles the three behind one handle; the ``telemetry=``
arguments of ``Trainer.run``, ``api.fit``, ``api.tune`` and the CLI accept
``None``, a directory path or a bundle through :func:`as_telemetry`.

Apart from them, :mod:`~repro_torch.obs.spans` puts spans and counters
inside the training step on the profiler's clock (:func:`span`,
:func:`count`), at no cost while no profiler records.
"""
from .events import (
    NULL_EVENTS,
    SCHEMA_PATH,
    EventLog,
    load_schema,
    plan_digest,
    validate_event,
)
from .registry import (
    NULL_INSTRUMENT,
    NULL_REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from .spans import count, counters, recording, reset_counters, span
from .telemetry import NULL_TELEMETRY, Telemetry, as_telemetry

__all__ = [
    "Counter",
    "EventLog",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_EVENTS",
    "NULL_INSTRUMENT",
    "NULL_REGISTRY",
    "NULL_TELEMETRY",
    "SCHEMA_PATH",
    "Telemetry",
    "as_telemetry",
    "count",
    "counters",
    "load_schema",
    "plan_digest",
    "recording",
    "reset_counters",
    "span",
    "validate_event",
]
