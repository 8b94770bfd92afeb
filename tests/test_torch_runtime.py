"""The port's adaptive runtime (``repro_torch.runtime``: monitor, controller,
the trainer's ``run(autotune=...)``) against ``repro.runtime``, on the
REDUCED gpt2-paper, with SGD.

Against the reference, on the same inputs:

* ``CCRMonitor`` and ``PhaseSample``: the same means, CCRs and summaries;
* ``ReplanController``: the same CCR sequences (from a numpy seed) give the
  same decisions, reasons, re-plan steps and breaker latch;
* trainers driven by the reference's synthetic probes (an injected comm
  slowdown, a link that recovers mid-run) re-plan at the same steps to the
  same intervals, carry residual norms equal at rtol 1e-6, and end with
  params at the trainer tests' SGD bound (rtol 1e-4, atol 1e-6);
* ``exposed_comm_scale`` is 0.5 on a W = 8 sharded plan and 1.0 otherwise.

And the properties that only the port has, since its step updates state
in place:

* the real ``PhaseProbe`` leaves params, optimizer and compressor state
  bitwise as they were (every execution form, and the pending sharded
  gather untouched);
* a run armed with the real probe that never re-plans (``max_replans=0``)
  equals the ``autotune=None`` run bit for bit, and ``autotune=None`` is
  the static loop of ``Trainer.step`` bit for bit;
* only probe-due steps wait for the device."""
import json
import math
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.core import get_compressor as r_get_compressor
from repro.core.ccr import HardwareSpec as RHardwareSpec
from repro.data import DataConfig as RDataConfig
from repro.data import make_loader as r_make_loader
from repro.models import build_model as r_build_model
from repro.optim import sgd as r_sgd
from repro.runtime import AutotuneConfig as RAutotuneConfig
from repro.runtime import CCRMonitor as RCCRMonitor
from repro.runtime import PhaseSample as RPhaseSample
from repro.runtime import ReplanController as RReplanController
from repro.runtime import exposed_comm_scale as r_exposed_comm_scale
from repro.runtime import synthetic_probe as r_synthetic_probe
from repro.train.trainer import TrainConfig as RTrainConfig
from repro.train.trainer import Trainer as RTrainer

import repro_torch.configs as tconfigs
import repro_torch.obs as obs
import repro_torch.train.trainer as trainer_mod
from repro_torch import optim
from repro_torch.core import build_plan, get_compressor
from repro_torch.core.ccr import HardwareSpec
from repro_torch.core.perfmodel import calibrate_from_trace
from repro_torch.data import DataConfig, make_loader
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.runtime import (
    AdaptiveRuntime,
    AutotuneConfig,
    CCRMonitor,
    PhaseProbe,
    PhaseSample,
    ReplanController,
    as_autotune_config,
    build_schedule_only_fn,
    exposed_comm_scale,
    measure_workload_ccr,
    synthetic_probe,
)
from repro_torch.train import TrainConfig, Trainer

torch.set_num_threads(2)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

PLAN_KW = dict(bucket_bytes=1 << 14, max_buckets=32)
TC = dict(compressor="covap", log_every=1, **PLAN_KW)
DATA = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)
LR = 1e-2


# ---------------------------------------------------------------------------
# monitor and controller against the reference
# ---------------------------------------------------------------------------

def _samples(cls, seed, n=12):
    rng = np.random.default_rng(seed)
    return [cls(phase=int(rng.integers(0, 3)), t_comp=float(rng.uniform(0.01, 1)),
                t_comm=float(rng.uniform(0, 2)), step=i,
                t_full=float(rng.uniform(0, 2)) if rng.random() > 0.4 else 0.0)
            for i in range(n)]


@pytest.mark.parametrize("seed", range(3))
def test_monitor_equals_reference(seed):
    got, want = CCRMonitor(window=5), RCCRMonitor(window=5)
    for s, r in zip(_samples(PhaseSample, seed), _samples(RPhaseSample, seed)):
        assert (s.ccr, s.achieved_overlap) == (r.ccr, r.achieved_overlap)
        got.record_sample(s)
        want.record_sample(r)
        got.record_step(s.step, s.phase, s.t_full)
        want.record_step(r.step, r.phase, r.t_full)
        for phase in (None, 0, 1, 2):
            assert got.measured_times(phase) == want.measured_times(phase)
            assert got.mean_step_time(phase) == want.mean_step_time(phase)
        assert got.summary() == want.summary()
    got.clear_samples()
    want.clear_samples()
    assert got.summary() == want.summary() and got.num_samples == 0


CONTROLLERS = [
    dict(),
    dict(hysteresis=0.1, patience=3, cooldown_steps=8),
    dict(patience=1, cooldown_steps=0, max_replans=2),
    dict(patience=1, cooldown_steps=0, breaker_replans=3, breaker_window_steps=40),
    dict(patience=2, cooldown_steps=0, max_interval=6, breaker_replans=0),
]


def _ccrs(seed, n=60):
    rng = np.random.default_rng(seed)
    ccrs = list(rng.choice([0.3, 1.7, 3.2, 4.0, 5.5, 12.9, 80.0], n))
    return [None if rng.random() < 0.1 else float(c) for c in ccrs]


def _state(ctrl):
    return (ctrl.interval, ctrl.pending, ctrl.replans, ctrl.last_replan_step,
            ctrl.replan_steps, ctrl.frozen, ctrl.freeze_reason)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cfg", range(len(CONTROLLERS)))
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_controller_equals_reference(seed, cfg, scale):
    got = ReplanController(AutotuneConfig(**CONTROLLERS[cfg]), interval=4,
                           exposed_scale=scale)
    want = RReplanController(RAutotuneConfig(**CONTROLLERS[cfg]), interval=4,
                             exposed_scale=scale)
    for step, c in zip(range(0, 240, 4), _ccrs(seed)):
        assert got.observe(step, c).__dict__ == want.observe(step, c).__dict__
        assert _state(got) == _state(want)
        assert got.consistent(c or 0.0) == want.consistent(c or 0.0)
    for ctrl in (got, want):
        ctrl.reset_breaker()
        ctrl.freeze("operator")
    assert got.observe(999, 9.0).__dict__ == want.observe(999, 9.0).__dict__
    assert _state(got) == _state(want)


def test_breaker_latches_and_resets_like_the_reference():
    cfg = dict(patience=1, cooldown_steps=0, breaker_replans=2, breaker_window_steps=10)
    got = ReplanController(AutotuneConfig(**cfg), interval=1)
    want = RReplanController(RAutotuneConfig(**cfg), interval=1)
    for step in range(8):
        c = [10.0, 1.0][step % 2]
        assert got.observe(step, c).__dict__ == want.observe(step, c).__dict__
    assert got.frozen and got.replans == 2
    assert got.decisions[-1].reason.startswith("circuit-open:2 replans in 10 steps")
    got.reset_breaker()
    assert not got.frozen and got.replan_steps == [] and got.observe(9, 10.0).replan


def test_autotune_config_fields_and_coercion_equal_reference():
    import dataclasses

    got = {f.name: f.default for f in dataclasses.fields(AutotuneConfig)}
    want = {f.name: f.default for f in dataclasses.fields(RAutotuneConfig)}
    assert got == want
    assert as_autotune_config(None) is None and as_autotune_config(False) is None
    assert as_autotune_config(True) == AutotuneConfig()
    cfg = AutotuneConfig(window=3)
    assert as_autotune_config(cfg) is cfg
    with pytest.raises(TypeError, match="autotune must be"):
        as_autotune_config("yes")


# ---------------------------------------------------------------------------
# exposed_comm_scale
# ---------------------------------------------------------------------------

def _fake_trainer(pkg, sync, world):
    shapes = jax.eval_shape(r_build_model(rconfigs.get_reduced("gpt2-paper")).init,
                            jax.random.PRNGKey(0))
    if pkg == "ref":
        plan, comp = (r_build_plan(shapes, interval=4, **PLAN_KW),
                      r_get_compressor("covap", interval=4, sync=sync))
    else:
        model = build_model(tconfigs.get_reduced("gpt2-paper"), device="meta")
        plan, comp = (build_plan(model.named_leaves(), interval=4, **PLAN_KW),
                      get_compressor("covap", interval=4, sync=sync))
    return types.SimpleNamespace(
        tc=types.SimpleNamespace(sync=sync), dp_world=world,
        schedules=lambda: [comp.plan_phase(plan, p, world=world) for p in range(4)])


@pytest.mark.parametrize("sync,world,want", [("sharded", 8, 0.5), ("sharded", 2, 0.5),
                                             ("sharded", 1, 1.0), ("allreduce", 8, 1.0)])
def test_exposed_comm_scale_equals_reference(sync, world, want):
    """Bitwise on the same spec; with each package's default spec (the
    reference's is a TPU's, the port's the paper's V100 environment) both
    are 0.5 up to rounding, since the flat plan's ratio does not depend on
    the bandwidth."""
    port, ref = _fake_trainer("port", sync, world), _fake_trainer("ref", sync, world)
    got = exposed_comm_scale(port, HardwareSpec.cloud_v100_30gbps())
    assert got == r_exposed_comm_scale(ref, RHardwareSpec.cloud_v100_30gbps())
    assert got == pytest.approx(want, rel=1e-12)
    assert exposed_comm_scale(port) == got
    assert r_exposed_comm_scale(ref) == pytest.approx(want, rel=1e-12)


# ---------------------------------------------------------------------------
# trainers driven by synthetic probes, against the reference
# ---------------------------------------------------------------------------

def _trainers(interval, **kw):
    tc = {**TC, "interval": interval, **kw}
    rtr = RTrainer(r_build_model(rconfigs.get_reduced("gpt2-paper")),
                   r_sgd(LR, momentum=0.9), RTrainConfig(**tc))
    rstate = rtr.init_state(jax.random.PRNGKey(0))
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, rstate["params"]),
                                          device="cpu"))
    tr = Trainer(model, optim.sgd(LR, momentum=0.9), TrainConfig(**tc))
    return rtr, rstate, tr, tr.init_state()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


SCENARIOS = {
    # an injected comm slowdown: CCR 2.6 from I = 2 re-plans to ceil = 3
    "slowdown": (2, dict(measure_every=1, warmup_steps=1, window=2, patience=2,
                         cooldown_steps=2), 2.6),
    # the link recovers after step 2: from I = 4 back down to 2
    "drift": (4, dict(measure_every=1, warmup_steps=0, window=1, patience=2,
                      cooldown_steps=2), lambda step: 4.0 if step < 3 else 1.5),
    # chip_smoke.py's [adaptive] synthetic run (ADAPTIVE_CONFIG,
    # ADAPTIVE_SYNTHETIC): from I = 4 to 2 after step 1 (ADAPTIVE_REPLAN_STEP)
    "chip_smoke": (4, dict(measure_every=2, warmup_steps=1, window=1, patience=1,
                           cooldown_steps=0, probe_warmup=1, probe_iters=2), 1.6),
}
REPLAN = {"slowdown": (3, [2]), "drift": (2, [3]), "chip_smoke": (2, [1])}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_synthetic_probe_runs_replan_like_the_reference(scenario):
    interval, kw, ccr = SCENARIOS[scenario]
    steps = 6
    rtr, rstate, tr, state = _trainers(interval)
    rstate = rtr.run(rstate, iter(r_make_loader(RDataConfig(**DATA))), steps=steps,
                     log=None, autotune=RAutotuneConfig(
                         probe=r_synthetic_probe(0.01, ccr), **kw))
    lines = []
    state = tr.run(state, iter(make_loader(DataConfig(**DATA), device="cpu")),
                   steps=steps, log=lines.append,
                   autotune=AutotuneConfig(probe=synthetic_probe(0.01, ccr), **kw))
    rt, rrt = tr.runtime, rtr.runtime
    assert [d.__dict__ for d in rt.controller.decisions] == \
        [d.__dict__ for d in rrt.controller.decisions]
    assert rt.controller.replan_steps == rrt.controller.replan_steps
    assert rt.controller.replans == 1 and tr.tc.interval == rtr.tc.interval
    assert (tr.tc.interval, rt.controller.replan_steps) == REPLAN[scenario]
    assert tr.num_phases == tr.tc.interval
    assert sum(line.startswith("[autotune] step") for line in lines) == 1
    for rep, rrep in zip(tr.transitions, rtr.transitions, strict=True):
        assert (rep.step, rep.old_interval, rep.new_interval, rep.policy) == (
            rrep.step, rrep.old_interval, rrep.new_interval, rrep.policy) == (
            rep.step, interval, tr.tc.interval, "carry")
        assert rep.norm_before == rep.norm_after
        assert rep.norm_before == pytest.approx(rrep.norm_before, rel=1e-6)
    summary, rsummary = rt.summary(), rrt.summary()
    for key in ("interval", "replans", "breaker_open", "breaker_reason", "measured_ccr"):
        assert summary[key] == rsummary[key]
    assert state["step"] == rstate["step"] == steps
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in rtr.history], rtol=1e-5)
    flat = _flat(rstate["params"])
    rcomp = _flat(rstate["comp"])
    for path, p, r in zip(tr.leaf_names, state["params"], state["comp"], strict=True):
        np.testing.assert_allclose(p.detach().numpy(), flat[path], rtol=1e-4, atol=1e-6,
                                   err_msg=path)
        np.testing.assert_allclose(r.numpy(), rcomp[path], rtol=1e-4, atol=1e-6,
                                   err_msg=path)


def test_chunked_runs_share_one_runtime():
    """A live ``AdaptiveRuntime`` passed to each chunk keeps its patience
    across chunks (the checkpoint-every loop), as the reference's does."""
    _, _, tr, state = _trainers(2)
    cfg = AutotuneConfig(measure_every=2, warmup_steps=0, window=2, patience=2,
                         cooldown_steps=0, probe=synthetic_probe(0.01, 2.6))
    rt = AdaptiveRuntime(tr, cfg)
    it = iter(make_loader(DataConfig(**DATA), device="cpu"))
    for _ in range(2):      # 2 chunks x 2 steps: one probe decision per chunk
        state = tr.run(state, it, steps=2, log=None, autotune=rt)
    assert tr.runtime is rt and rt.controller.replans == 1 and tr.tc.interval == 3


def test_adaptive_run_with_telemetry_traces_and_logs_valid_events(tmp_path):
    _, _, tr, state = _trainers(2)
    tel = obs.Telemetry(str(tmp_path / "tel"))
    path = str(tmp_path / "run_trace.json")
    cfg = AutotuneConfig(measure_every=1, warmup_steps=1, window=2, patience=1,
                         cooldown_steps=2, probe=synthetic_probe(0.01, 2.6),
                         trace_path=path)
    tr.run(state, iter(make_loader(DataConfig(**DATA), device="cpu")), steps=4,
           log=None, autotune=cfg, telemetry=tel)
    tel.save()
    tel.close()
    with open(tmp_path / "tel" / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    kinds = [e["kind"] for e in events]
    assert kinds.count("probe") == kinds.count("replan_decision") == 3
    assert kinds.count("replan") == 1 and kinds[0] == "manifest"
    assert all(obs.validate_event(e) == [] for e in events)
    for p in (path, str(tmp_path / "tel" / "trace.json")):
        with open(p) as f:
            trace = json.load(f)
        cats = {c for e in trace["traceEvents"] for c in e.get("cat", "").split(",") if c}
        assert {"measured", "planned", "control"} <= cats
        assert calibrate_from_trace(trace)["ccr"] == pytest.approx(2.6, rel=1e-3)


# ---------------------------------------------------------------------------
# the real probe: the live state stays as it was
# ---------------------------------------------------------------------------

def _parts(state):
    opt = state["opt"]
    comp = state["comp"]
    comp = ([x for x in comp["residual"] + comp["q"] if x is not None]
            if isinstance(comp, dict) else list(comp))
    return ([p.detach().clone() for p in state["params"]]
            + [x.clone() for x in opt.get("mu", []) + opt.get("m", []) + opt.get("v", [])]
            + [x.clone() for x in comp] + [state["step"], opt["step"]])


def _equal(a, b):
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(a, b))


FORMS = {
    "defaults": {},
    "arena": {"arena": True},
    "sharded": {"sync": "sharded"},
    "fused": {"overlap": "fused"},
    "fused-arena-sharded": {"overlap": "fused", "arena": True, "sync": "sharded"},
    "fp8wire": {"compressor": "fp8wire"},
    "powersgd": {"compressor": "powersgd"},
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_real_probe_leaves_the_state_bitwise(form):
    _, _, tr, state = _trainers(2, **FORMS[form])
    loader = make_loader(DataConfig(**DATA), device="cpu")
    batch = loader.make(2)
    state = tr.run(state, iter([loader.make(s) for s in range(2)]), steps=2, log=None)
    tr._pending_sync = tr.sharded
    before = _parts(state)
    probe = PhaseProbe(tr, warmup=1, iters=1)
    for phase in range(tr.num_phases):
        sample = probe(state, batch, phase)
        assert _equal(_parts(state), before), f"phase {phase} changed the state"
        assert sample.phase == phase and sample.step == 2
        assert sample.t_comp > 0 and sample.t_comm >= 0 and sample.t_full > 0
        assert math.isfinite(sample.ccr)
    assert tr._pending_sync == tr.sharded
    probe.invalidate()
    assert probe._comm_only is None and not probe._compute_only


def test_never_replanning_real_probe_run_is_bitwise_the_static_run():
    runs = []
    for autotune in (None, AutotuneConfig(measure_every=1, warmup_steps=0, max_replans=0,
                                          probe_warmup=1, probe_iters=1)):
        _, _, tr, state = _trainers(2)
        state = tr.run(state, iter(make_loader(DataConfig(**DATA), device="cpu")),
                       steps=3, log=None, autotune=autotune)
        runs.append((_parts(state), [h["loss"] for h in tr.history]))
    assert _equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    assert tr.runtime.monitor.num_samples == 3 and tr.runtime.controller.replans == 0


@pytest.mark.parametrize("form", ["defaults", "sharded"])
def test_autotune_off_is_bitwise_the_static_step_loop(form):
    runs = []
    for use_run in (True, False):
        _, _, tr, state = _trainers(2, **FORMS[form])
        it = iter(make_loader(DataConfig(**DATA), device="cpu"))
        if use_run:
            state = tr.run(state, it, steps=3, log=None, autotune=None, telemetry=None)
        else:
            for _ in range(3):
                state, _ = tr.step(state, next(it))
        runs.append(_parts(state))
    assert _equal(*runs)


def test_only_probe_due_steps_wait_for_the_device(monkeypatch):
    calls = []
    monkeypatch.setattr(trainer_mod, "synchronize", lambda device: calls.append(device))
    _, _, tr, state = _trainers(2)
    it = iter(make_loader(DataConfig(**DATA), device="cpu"))
    state = tr.run(state, it, steps=3, log=None)
    assert calls == []
    cfg = AutotuneConfig(measure_every=2, warmup_steps=1, probe=synthetic_probe(0.01, 2.0))
    tr.run(state, it, steps=5, log=None, autotune=cfg)
    assert calls == [torch.device("cpu")] * 2          # steps 1 and 3 of the 5
    assert tr.runtime.monitor.summary()["steps_recorded"] == 2


def test_schedule_only_fn_without_group_and_workload_ccr():
    _, _, tr, state = _trainers(2)
    dense = get_compressor("none").plan_phase(tr.plan, 0, world=1)
    build_schedule_only_fn(dense, device="cpu")()
    build_schedule_only_fn(dense.__class__(**{**dense.__dict__, "calls": ()}),
                           device="cpu")()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_schedule_only_fn(dense)          # the card unless asked
    loader = make_loader(DataConfig(**DATA), device="cpu")
    out = measure_workload_ccr(tr, state, loader.make(0), warmup=0, iters=1)
    assert sorted(out["per_phase"]) == [0, 1] and out["n"] == 2
    assert out["t_comp"] > 0 and math.isfinite(out["ccr"])


def test_resilience_arguments_raise():
    """``guards`` and ``faults``, once refused, arm the resilience runtime of
    ``Trainer.run`` (``test_torch_resilience.py`` holds it against the
    reference)."""
    from repro_torch.resilience import ResilienceRuntime

    loader = make_loader(DataConfig(**DATA), device="cpu")
    for kw in ({"guards": True}, {"faults": "grad_nan@1"}):
        _, _, tr, state = _trainers(2)
        state = tr.run(state, iter([loader.make(s) for s in range(2)]), steps=2,
                       log=None, **kw)
        assert isinstance(tr.resilience, ResilienceRuntime) and state["step"] == 2
        assert (tr.resilience.guards is None) == ("faults" in kw)


def test_reattaching_the_same_telemetry_changes_nothing():
    """Each chunk of a checkpoint-every loop hands the runtime the bundle
    it already writes to.  The reference copies the tracer's events into
    the bundle's tracer, which is by then the same deque, and raises; the
    port's attach is then a no-op (a reference problem, not ported)."""
    from repro.obs import Telemetry as RTelemetry
    from repro.runtime import AdaptiveRuntime as RAdaptiveRuntime

    fake = types.SimpleNamespace(tc=types.SimpleNamespace(interval=2, sync="allreduce"),
                                 dp_world=1)
    for runtime, config, probe, bundle, raises in (
            (RAdaptiveRuntime, RAutotuneConfig, r_synthetic_probe, RTelemetry, True),
            (AdaptiveRuntime, AutotuneConfig, synthetic_probe, obs.Telemetry, False)):
        rt = runtime(fake, config(probe=probe(0.01, 1.0)))
        rt.tracer.record_replan(0, 2, 2, "before the attach")
        tel = bundle()
        rt.attach_telemetry(tel)
        if raises:
            with pytest.raises(RuntimeError, match="deque mutated during iteration"):
                rt.attach_telemetry(tel)
        else:
            rt.attach_telemetry(tel)
            assert rt.tracer is tel.tracer and len(tel.tracer.events) == 1


def test_cli_adaptive_with_telemetry_and_checkpoints(tmp_path):
    """``--interval adaptive`` (the analytic pick, then the runtime) over a
    chunked checkpoint-every loop with one runtime and one bundle."""
    tel, ckpt = tmp_path / "tel", tmp_path / "ckpt"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--steps", "4",
         "--seq-len", "16", "--global-batch", "4", "--device", "cpu", "--log-every", "2",
         "--interval", "adaptive", "--telemetry-dir", str(tel), "--ckpt-dir", str(ckpt),
         "--ckpt-every", "2"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ,
                 PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", "")))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[ccr] analytic CCR=2552.08 -> interval I=64" in r.stdout
    assert "[autotune] measured CCR" in r.stdout and "[telemetry]" in r.stdout
    assert sorted(os.listdir(tel)) == ["events.jsonl", "metrics.json", "metrics.prom",
                                       "trace.json"]
    with open(tel / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    kinds = [e["kind"] for e in events]
    assert kinds.count("manifest") == 1 and kinds.count("checkpoint") == 2
    assert kinds.count("probe") == 0      # the default warmup is 4 steps
    assert all(obs.validate_event(e) == [] for e in events)
