"""Structured JSONL event log: the narrative half of telemetry (the
counterpart of ``repro.obs.events``).

The metrics registry answers "how much, how fast"; this log answers *why*:
it records the run manifest (config, world, plan digest), step records,
checkpoint and flush boundaries, and the :class:`ReplanController`'s
decision audit trail (measured CCR, hysteresis state, chosen interval), so
that every re-plan of a run is explainable after the fact.

Every line is one JSON object and validates against ``event_schema.json``
(the reference's schema, copied beside this module), checked at emit time.
The schema is a small declarative format, required and optional field
names with primitive types per event kind, validated by
:func:`validate_event` with no third-party dependency.

With no ``path`` the log buffers in memory (``records``), which is what
``api.fit(telemetry=...)`` hands back; with a path each event is appended
and flushed as it happens, so a crashed run keeps everything up to the
crash.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any

SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "event_schema.json")

_TYPE_CHECKS = {
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "string": lambda v: isinstance(v, str),
    "boolean": lambda v: isinstance(v, bool),
    "object": lambda v: isinstance(v, dict),
    "array": lambda v: isinstance(v, list),
    "null": lambda v: v is None,
}

_schema_cache: dict | None = None


def load_schema() -> dict:
    global _schema_cache
    if _schema_cache is None:
        with open(SCHEMA_PATH) as f:
            _schema_cache = json.load(f)
    return _schema_cache


def _check_type(value: Any, typ: str) -> bool:
    if typ.endswith("?"):
        if value is None:
            return True
        typ = typ[:-1]
    return _TYPE_CHECKS[typ](value)


def validate_event(event: dict, schema: dict | None = None) -> list[str]:
    """Validate one event dict against the schema; returns a list of error
    strings (empty = valid).  Checks: base fields present and typed, kind
    known, per-kind required fields present and typed, optional fields
    typed when present.  Unknown extra fields are allowed (forward
    compatibility) — the schema pins what consumers may rely on."""
    schema = schema or load_schema()
    errors: list[str] = []
    if not isinstance(event, dict):
        return [f"event is {type(event).__name__}, expected object"]
    for field, typ in schema["base"].items():
        if field not in event:
            errors.append(f"missing base field {field!r}")
        elif not _check_type(event[field], typ):
            errors.append(f"base field {field!r} is not {typ}")
    kind = event.get("kind")
    if not isinstance(kind, str):
        return errors
    spec = schema["kinds"].get(kind)
    if spec is None:
        errors.append(f"unknown event kind {kind!r}")
        return errors
    for field, typ in spec.get("required", {}).items():
        if field not in event:
            errors.append(f"{kind}: missing required field {field!r}")
        elif not _check_type(event[field], typ):
            errors.append(f"{kind}: field {field!r} is not {typ}")
    for field, typ in spec.get("optional", {}).items():
        if field in event and not _check_type(event[field], typ):
            errors.append(f"{kind}: optional field {field!r} is not {typ}")
    return errors


def plan_digest(plan) -> str:
    """Stable short digest of a ``BucketPlan``'s structure — enough to tell
    after the fact whether two runs (or two sides of a re-plan) executed
    the same bucketing, without storing the whole plan."""
    h = hashlib.sha256()
    h.update(str(plan.interval_hint).encode())
    for bucket in plan.buckets:
        h.update(str(bucket.numel).encode())
        for seg in bucket.segments:
            h.update(
                f"{seg.leaf_idx}:{seg.row_lo}:{seg.row_hi}:"
                f"{seg.sub_axis}:{seg.sub_lo}:{seg.sub_hi}".encode()
            )
    return h.hexdigest()[:16]


def _jsonable(v):
    """Best-effort coercion of config-ish values to JSON."""
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class EventLog:
    """Append-only JSONL event stream with emit-time schema validation.

    ``enabled=False`` (or the shared :data:`NULL_EVENTS`) turns ``emit``
    into an early-return — the disabled cost is one attribute check."""

    def __init__(
        self,
        path: str | None = None,
        *,
        run_id: str | None = None,
        enabled: bool = True,
        validate: bool = True,
        max_records: int = 100_000,
        clock=time.time,
    ):
        self.enabled = bool(enabled)
        self.path = path
        self.run_id = run_id or f"run-{os.getpid()}-{int(clock() * 1e3):x}"
        self.validate = bool(validate)
        self.clock = clock
        self.records: list[dict] = []      # in-memory tail (bounded ring)
        self._max_records = int(max_records)
        self._fh = None
        if self.enabled and path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def emit(self, kind: str, **fields) -> dict | None:
        """Record one event; returns the event dict (or None when
        disabled).  Raises ``ValueError`` on schema violations when
        ``validate`` — a malformed event is a bug at the call site, not
        something to discover when the JSONL is consumed."""
        if not self.enabled:
            return None
        event = {"ts": float(self.clock()), "kind": kind,
                 "run_id": self.run_id}
        event.update({k: _jsonable(v) for k, v in fields.items()})
        if self.validate:
            errors = validate_event(event)
            if errors:
                raise ValueError(
                    f"invalid {kind!r} event: " + "; ".join(errors)
                )
        self.records.append(event)
        if len(self.records) > self._max_records:
            del self.records[: len(self.records) - self._max_records]
        if self._fh is not None:
            self._fh.write(json.dumps(event) + "\n")
            self._fh.flush()
        return event

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


NULL_EVENTS = EventLog(enabled=False)

__all__ = [
    "EventLog",
    "NULL_EVENTS",
    "SCHEMA_PATH",
    "load_schema",
    "plan_digest",
    "validate_event",
]
