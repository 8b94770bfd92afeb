"""Serving: continuous batching over a statically-planned paged KV arena,
with chunked prefill -> insert -> generate stages and a synthetic-traffic
harness — the counterpart of ``repro.serve``, with the same names."""
from .engine import Engine, ServeConfig, build_generate_fn, greedy_sample
from .kv_arena import (
    KVArena,
    KVLayout,
    PagePool,
    build_insert_fn,
    gather_caches,
    plan_kv_layout,
    scatter_step,
)
from .prefill import ChunkedPrefill
from .scheduler import (
    FINISH_EOS,
    FINISH_LENGTH,
    FINISH_REJECTED,
    FINISH_TRUNCATED,
    Completion,
    Request,
    Scheduler,
)
from .traffic import TrafficConfig, TrafficReport, run_traffic, sweep

__all__ = [
    "ChunkedPrefill",
    "Completion",
    "Engine",
    "FINISH_EOS",
    "FINISH_LENGTH",
    "FINISH_REJECTED",
    "FINISH_TRUNCATED",
    "KVArena",
    "KVLayout",
    "PagePool",
    "Request",
    "Scheduler",
    "ServeConfig",
    "TrafficConfig",
    "TrafficReport",
    "build_generate_fn",
    "build_insert_fn",
    "gather_caches",
    "greedy_sample",
    "plan_kv_layout",
    "run_traffic",
    "scatter_step",
    "sweep",
]
