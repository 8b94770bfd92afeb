"""The port's ``TimelineTracer`` (``repro_torch.runtime.trace``) and
``calibrate_from_trace`` against ``repro.runtime.trace`` and
``repro.core.perfmodel``: the same call sequence, with inputs made from a
numpy seed, gives equal ``to_chrome_trace()`` dicts (the same pids, tids,
categories and ``ts``/``dur`` in µs), and calibration gives equal results
on the same trace.  ``align_comm_times`` (``core.ccr``) is held there too."""
import json
import types

import jax
import numpy as np
import pytest

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.core import ccr as rccr
from repro.core import get_compressor as r_get_compressor
from repro.core.perfmodel import calibrate_from_trace as r_calibrate
from repro.models import build_model as r_build_model
from repro.runtime import PhaseSample as RPhaseSample
from repro.runtime import TimelineTracer as RTimelineTracer

import repro_torch.configs as tconfigs
from repro_torch.core import build_plan, ccr, get_compressor
from repro_torch.core.perfmodel import calibrate_from_trace
from repro_torch.models import build_model
from repro_torch.runtime import PhaseSample, TimelineTracer
from repro_torch.runtime import trace as ttrace

PLAN_KW = dict(bucket_bytes=1 << 14, max_buckets=32)


def _plans(interval=4):
    shapes = jax.eval_shape(r_build_model(rconfigs.get_reduced("gpt2-paper")).init,
                            jax.random.PRNGKey(0))
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="meta")
    return (r_build_plan(shapes, interval=interval, **PLAN_KW),
            build_plan(model.named_leaves(), interval=interval, **PLAN_KW))


def _completion(rng, rid, truncated=False):
    submit = float(rng.uniform(0, 1))
    admit = submit + float(rng.uniform(0, 0.1))
    first = admit + float(rng.uniform(0, 0.1))
    return types.SimpleNamespace(
        rid=rid, prompt_len=int(rng.integers(1, 64)), tokens=[1, 2, 3],
        finish_reason="length" if not truncated else "rejected", submit_s=submit,
        admit_s=None if truncated else admit,
        first_token_s=None if truncated else first,
        prefill_end_s=admit + 0.01 if rid % 2 else None,
        finish_s=first + float(rng.uniform(0, 0.5)))


def _drive(tracer, sample_cls, rng, schedules, world):
    """One call sequence, every method of the tracer."""
    for s in range(5):
        tracer.record_step(s, s % 2, float(rng.uniform(0.05, 0.2)))
        smp = sample_cls(phase=s % 2, t_comp=float(rng.uniform(0.01, 0.1)),
                         t_comm=float(rng.uniform(0, 0.05)), step=s,
                         t_full=float(rng.uniform(0.05, 0.2)))
        tracer.record_sample(smp, bytes_on_wire=int(rng.integers(1, 1 << 30)))
        tracer.record_sample(smp)
    starts = rng.uniform(0, 1, (3, 4))
    ends = starts + rng.uniform(0, 1, (3, 4))
    tracer.record_aligned_collectives(7, ["a", "b", "c", "d"], starts, ends,
                                      bytes_per_op=[1, 2, 3, 4])
    tracer.record_aligned_collectives(8, ["a", "b", "c", "d"], starts, ends)
    for sched in schedules:
        tracer.record_planned_phase(sched, t_before=0.01, t_comp=0.02,
                                    link_bw=3.75e9, world=world, at_s=0.5)
        tracer.record_planned_buckets(sched, world=world, link_bw=3.75e9, at_s=0.1)
        tracer.record_planned_buckets(sched)
    tracer.record_replan(9, 4, 2, "ccr 1.50 -> I 2")
    for rid in range(3):
        tracer.record_request(_completion(rng, rid, truncated=rid == 2), t0=0.05)
    tracer.record_counter("queue", 0.3, {"depth": 3, "pages": 7.5})


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name,world", [("covap", 8), ("covap-sharded", 8),
                                         ("powersgd", 2), ("oktopk", 4)])
def test_chrome_trace_equals_reference(seed, name, world):
    rplan, plan = _plans()
    opts = ({"interval": 4} if name.startswith("covap") else
            {"rank": 2} if name == "powersgd" else {"ratio": 0.01})
    if name.endswith("sharded"):
        opts["sync"] = "sharded"
    comp = name.split("-")[0]
    rscheds = [r_get_compressor(comp, **opts).plan_phase(rplan, p, world=world)
               for p in range(2)]
    scheds = [get_compressor(comp, **opts).plan_phase(plan, p, world=world)
              for p in range(2)]
    want, got = RTimelineTracer(), TimelineTracer()
    _drive(want, RPhaseSample, np.random.default_rng(seed), rscheds, world)
    _drive(got, PhaseSample, np.random.default_rng(seed), scheds, world)
    assert got.to_chrome_trace() == want.to_chrome_trace()
    assert calibrate_from_trace(got.to_chrome_trace()) == r_calibrate(want.to_chrome_trace())
    assert calibrate_from_trace(list(got.events)) == r_calibrate(list(want.events))


def test_ring_buffer_and_save_round_trip(tmp_path):
    want, got = RTimelineTracer(max_events=7), TimelineTracer(max_events=7)
    for tr, cls in ((want, RPhaseSample), (got, PhaseSample)):
        for s in range(6):
            tr.record_step(s, 0, 0.1 + s)
            tr.record_sample(cls(phase=0, t_comp=0.1, t_comm=0.02, step=s),
                             bytes_on_wire=10 ** 6)
    assert len(got.events) == 7
    assert got.to_chrome_trace() == want.to_chrome_trace()
    path = got.save(str(tmp_path / "trace.json"))
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(want.to_chrome_trace()))
    assert (ttrace.PID_PLANNED, ttrace.PID_MEASURED, ttrace.PID_CONTROL,
            ttrace.PID_SERVE) == (1, 2, 3, 4)


def test_calibration_round_trip_matches_reference():
    """The reference's own round trip (its ``test_trace_chrome_export_and_
    calibration``), on both tracers."""
    for tr, cls, cal in ((TimelineTracer(), PhaseSample, calibrate_from_trace),
                         (RTimelineTracer(), RPhaseSample, r_calibrate)):
        for s in range(4):
            tr.record_step(s, s % 2, 0.12)
            tr.record_sample(cls(phase=s % 2, t_comp=0.10, t_comm=0.02, step=s),
                             bytes_on_wire=1_000_000)
        out = cal(tr.to_chrome_trace())
        assert out["t_comp"] == pytest.approx(0.10, rel=1e-6)
        assert out["ccr"] == pytest.approx(0.2, rel=1e-6)
        assert out["link_bw"] == pytest.approx(1_000_000 / 0.02, rel=1e-6)
    assert calibrate_from_trace({"traceEvents": []}) == r_calibrate({"traceEvents": []})


@pytest.mark.parametrize("seed", range(3))
def test_align_comm_times_equals_reference(seed):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(0, 1, (4, 6))
    ends = starts + rng.uniform(0, 1, (4, 6))
    got = ccr.align_comm_times(starts, ends)
    np.testing.assert_array_equal(got, rccr.align_comm_times(starts, ends))
    np.testing.assert_array_equal(got, ends.min(axis=0) - starts.max(axis=0))
