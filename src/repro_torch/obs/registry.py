"""Metrics registry: labeled counters, gauges and histograms with a
Prometheus textfile exposition and a flat ``snapshot()`` digest (the
counterpart of ``repro.obs.registry``).

* **Near-zero cost when disabled**: a disabled registry hands out one
  shared null instrument whose methods are no-ops; the hot path pays a
  dict lookup when it *creates* an instrument, never per observation.
  Callers hold the instrument, not the registry, so ``counter.inc()`` on
  an enabled registry is one float add.
* **Host-side only**: instruments record Python floats.  Reading a CUDA
  tensor's value waits for the device, so callers convert at points that
  already wait (the log cadence, probe steps).
* **The snapshot is the source of truth**: ``snapshot()`` flattens every
  instrument into ``{name_or_name{labels}: value}``, so a key exists in it
  iff some instrument recorded it.

Histograms keep a bounded window of recent observations (a ring buffer,
the monitor's discipline) for streaming p50/p99, and exact running
count/sum/min/max over the instrument's life.
"""
from __future__ import annotations

import collections
import math
from typing import Iterable


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in labels)
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _NullInstrument:
    """Shared no-op instrument of a disabled registry: every mutator is a
    method on this one object, so the disabled path costs one attribute
    call and returns immediately."""

    __slots__ = ()

    def inc(self, value: float = 1.0) -> None:
        pass

    def set(self, value) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


NULL_INSTRUMENT = _NullInstrument()


class Counter:
    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, value: float = 1.0) -> None:
        self.value += value


class Gauge:
    """Last-write-wins scalar.  ``None`` is a legal value: a gauge that was
    planned but never measured stays in the snapshot as ``None``."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = None

    def set(self, value) -> None:
        self.value = None if value is None else float(value)


class Histogram:
    """Streaming distribution: exact count/sum/min/max over everything
    observed, p50/p99 over the most recent ``window`` observations."""

    __slots__ = ("count", "sum", "min", "max", "_window")
    kind = "histogram"

    def __init__(self, window: int = 1024):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._window: collections.deque = collections.deque(maxlen=int(window))

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self._window.append(v)

    def percentile(self, q: float) -> float | None:
        """q in [0, 100] over the retained window (nearest-rank)."""
        if not self._window:
            return None
        xs = sorted(self._window)
        rank = max(0, min(len(xs) - 1, math.ceil(q / 100.0 * len(xs)) - 1))
        return xs[rank]

    def stats(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "p50": None, "p99": None}
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """One namespace of instruments.  ``counter/gauge/histogram`` are
    get-or-create: the same (name, labels) always returns the same
    instrument, and re-registering a name as a different kind raises."""

    def __init__(self, enabled: bool = True, *, hist_window: int = 1024):
        self.enabled = bool(enabled)
        self.hist_window = int(hist_window)
        # name -> (kind, help, {label_key: instrument})
        self._families: dict[str, tuple[str, str, dict]] = {}

    # ---- instrument creation ---------------------------------------------
    def _get(self, cls, name: str, help: str, labels: dict):
        if not self.enabled:
            return NULL_INSTRUMENT
        kind = cls.kind
        fam = self._families.get(name)
        if fam is None:
            fam = (kind, help, {})
            self._families[name] = fam
        elif fam[0] != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam[0]}, "
                f"cannot re-register as {kind}"
            )
        key = _label_key(labels)
        inst = fam[2].get(key)
        if inst is None:
            inst = cls(self.hist_window) if cls is Histogram else cls()
            fam[2][key] = inst
        return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        return self._get(Histogram, name, help, labels)

    # ---- read side --------------------------------------------------------
    def families(self) -> Iterable[tuple[str, str, str, dict]]:
        for name in sorted(self._families):
            kind, help, insts = self._families[name]
            yield name, kind, help, insts

    def snapshot(self) -> dict:
        """Flat ``{key: value}`` digest.  Un-labeled instruments use their
        bare name; labeled ones append ``{k="v",...}``.  Histograms expand into
        ``_count/_sum/_min/_max/_p50/_p99`` sub-keys."""
        out: dict = {}
        for name, kind, _help, insts in self.families():
            for key, inst in sorted(insts.items()):
                full = name + _label_str(key)
                if kind == "histogram":
                    for stat, v in inst.stats().items():
                        out[f"{full}_{stat}"] = v
                else:
                    out[full] = inst.value
        return out

    def to_prometheus_text(self) -> str:
        """Prometheus textfile exposition (node-exporter textfile-collector
        compatible).  Histograms are exported as summaries (quantile
        labels) since the window percentiles are precomputed."""
        lines: list[str] = []
        for name, kind, help, insts in self.families():
            if help:
                lines.append(f"# HELP {name} {_escape(help)}")
            lines.append(
                f"# TYPE {name} {'summary' if kind == 'histogram' else kind}"
            )
            for key, inst in sorted(insts.items()):
                if kind == "histogram":
                    st = inst.stats()
                    for q, stat in (("0.5", "p50"), ("0.99", "p99")):
                        if st[stat] is not None:
                            qkey = key + (("quantile", q),)
                            lines.append(
                                f"{name}{_label_str(qkey)} {st[stat]:g}"
                            )
                    lines.append(f"{name}_sum{_label_str(key)} {st['sum']:g}")
                    lines.append(f"{name}_count{_label_str(key)} {st['count']}")
                elif inst.value is not None:
                    lines.append(f"{name}{_label_str(key)} {inst.value:g}")
        return "\n".join(lines) + "\n"


NULL_REGISTRY = MetricsRegistry(enabled=False)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_INSTRUMENT",
    "NULL_REGISTRY",
]
