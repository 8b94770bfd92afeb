"""Synthetic high-QPS traffic for the serving engine — the counterpart of
``repro.serve.traffic``: ``synth_requests`` draws the same requests from
the same seed (numpy), and the pump and its report are the same.

"Millions of users" needs a measurable proxy: this module generates
Poisson arrivals at a target rate, pumps them through an
:class:`~repro_torch.serve.engine.Engine` on the wall clock, and aggregates each
request's :class:`~repro_torch.serve.scheduler.Completion` ledger into the
latency numbers that matter for serving (p50/p99 end-to-end latency,
time-to-first-token, sustained tokens/sec).  ``sweep`` repeats the run
across arrival rates on one engine (reset between rates, its layout and
functions reused) to expose the saturation knee.

Shed-and-retry (DESIGN.md §16): when the engine load-sheds
(``finish_reason="rejected"``, ``ServeConfig.max_queue``), the pump
resubmits up to ``max_retries`` times with exponential backoff
(``retry_backoff_s`` doubling per attempt) — the client half of graceful
degradation.  Latency is always measured from the ORIGINAL scheduled
arrival, so retries show up as honest tail latency, not as a reset clock.
With ``max_retries=0`` (default) a rejection is final and the pump
behaves exactly as before.
"""
from __future__ import annotations

import dataclasses
import heapq
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    qps: float = 8.0
    num_requests: int = 16
    prompt_len: tuple[int, int] = (4, 12)   # inclusive range
    vocab_size: int = 128
    seed: int = 0
    max_retries: int = 0           # resubmits per request after a rejection
    retry_backoff_s: float = 0.05  # first backoff; doubles per attempt


@dataclasses.dataclass(frozen=True)
class TrafficReport:
    qps: float
    num_requests: int
    generated_tokens: int
    makespan_s: float
    p50_ms: float
    p99_ms: float
    ttft_p50_ms: float
    tokens_per_s: float
    finish_reasons: dict[str, int]
    retries: int = 0               # total resubmissions across all requests

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def synth_requests(cfg: TrafficConfig) -> list[tuple[float, list[int]]]:
    """(arrival_offset_s, prompt) pairs with exponential inter-arrival
    gaps — a Poisson process at ``cfg.qps``."""
    rng = np.random.default_rng(cfg.seed)
    gaps = rng.exponential(1.0 / cfg.qps, size=cfg.num_requests)
    arrivals = np.cumsum(gaps)
    lo, hi = cfg.prompt_len
    out = []
    for a in arrivals:
        n = int(rng.integers(lo, hi + 1))
        prompt = rng.integers(1, cfg.vocab_size, size=n).tolist()
        out.append((float(a), [int(t) for t in prompt]))
    return out


def _percentile(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def run_traffic(engine, cfg: TrafficConfig, *, clock=time.perf_counter,
                sleep=time.sleep) -> TrafficReport:
    """Open-loop pump: requests are submitted at their scheduled arrival on
    ``clock`` whether or not the engine has caught up (queueing delay is
    part of the measured latency, as it would be for real traffic).
    Rejected submissions are resubmitted with exponential backoff up to
    ``cfg.max_retries`` times; the FINAL completion (retried or not) is
    what lands in the latency aggregate, timed from the original arrival.

    ``clock`` and ``sleep`` default to the wall clock.  A test passes a
    virtual pair, whose time moves only when it says so, to make the
    pump's arrivals, backoffs and outcomes independent of the machine's
    speed; the latencies subtract arrivals on ``clock`` from the engine's
    completion stamps (``time.perf_counter``), so they mean wall-clock
    time only with the default pair.
    """
    plan = synth_requests(cfg)
    submitted = 0
    live: dict[int, int] = {}       # rid -> plan index, awaiting completion
    final: dict[int, object] = {}   # plan index -> terminal Completion
    attempts = [0] * len(plan)
    retry_heap: list[tuple[float, int]] = []   # (due rel-time, plan index)
    retries_total = 0
    t0 = clock()
    while len(final) < len(plan):
        now = clock() - t0
        while submitted < len(plan) and plan[submitted][0] <= now:
            live[engine.submit(plan[submitted][1])] = submitted
            submitted += 1
        while retry_heap and retry_heap[0][0] <= now:
            _, idx = heapq.heappop(retry_heap)
            live[engine.submit(plan[idx][1])] = idx
        if engine.busy:
            engine.step()
        # resolve: rejected -> maybe retry; anything else is terminal
        for rid in [r for r in live if r in engine.results]:
            comp = engine.results[rid]
            idx = live.pop(rid)
            if (
                comp.finish_reason == "rejected"
                and attempts[idx] < cfg.max_retries
            ):
                attempts[idx] += 1
                retries_total += 1
                due = (clock() - t0) + cfg.retry_backoff_s * (
                    2 ** (attempts[idx] - 1)
                )
                heapq.heappush(retry_heap, (due, idx))
            else:
                final[idx] = comp
        if not engine.busy and len(final) < len(plan):
            waits = []
            if submitted < len(plan):
                waits.append(plan[submitted][0] - now)
            if retry_heap:
                waits.append(retry_heap[0][0] - now)
            if waits:
                sleep(min(0.05, max(0.0, min(waits))))
    t_end = clock()

    lat, ttft, reasons = [], [], {}
    gen_tokens = 0
    for idx, (arr, _prompt) in enumerate(plan):
        comp = final[idx]
        sched_s = t0 + arr  # ORIGINAL scheduled arrival, not any resubmit
        lat.append(comp.finish_s - sched_s)
        ttft.append(comp.first_token_s - sched_s)
        gen_tokens += len(comp.tokens)
        reasons[comp.finish_reason] = reasons.get(comp.finish_reason, 0) + 1
    makespan = max(t_end - t0, 1e-9)
    report = TrafficReport(
        qps=cfg.qps,
        num_requests=len(plan),
        generated_tokens=gen_tokens,
        makespan_s=makespan,
        p50_ms=1e3 * _percentile(lat, 50),
        p99_ms=1e3 * _percentile(lat, 99),
        ttft_p50_ms=1e3 * _percentile(ttft, 50),
        tokens_per_s=gen_tokens / makespan,
        finish_reasons=reasons,
        retries=retries_total,
    )
    tel = getattr(engine, "telemetry", None)
    if tel is not None and tel.enabled:
        tel.events.emit("serve_report", **report.as_dict())
        for k in ("p50_ms", "p99_ms", "ttft_p50_ms", "tokens_per_s"):
            tel.registry.gauge(
                f"serve_traffic_{k}", "last traffic-run aggregate",
                qps=f"{cfg.qps:g}",
            ).set(getattr(report, k))
    return report


def sweep(engine, qps_rates, base: TrafficConfig) -> list[TrafficReport]:
    """Arrival-rate sweep on one engine (reset between rates — its layout
    and functions are reused, only arena/queue state is rebuilt)."""
    reports = []
    for r in qps_rates:
        engine.reset()
        cfg = dataclasses.replace(base, qps=float(r))
        reports.append(run_traffic(engine, cfg))
    return reports


__all__ = ["TrafficConfig", "TrafficReport", "run_traffic", "sweep", "synth_requests"]
