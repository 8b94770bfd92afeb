"""The port's library surface (``repro_torch.api``) against ``repro.api``:
``resolve_interval`` (``"auto"`` and ``"adaptive"``), ``plan_report`` and
``tune`` give the reference's values on gpt2-paper (REDUCED and full width,
1, 8 and 64 modelled workers; ``tune``'s analytic columns at rtol 1e-9 in
the same row order), ``fit(interval="auto")`` picks the reference's
interval and trains within the trainer tests' tolerance of the reference's
``fit``, and ``fit(interval="adaptive")`` with a synthetic probe re-plans
as the reference's does.  ``guards`` and ``faults`` (the resilience runtime)
run beside the adaptive and telemetry options and return the runtime's
summary as ``FitResult.resilience``."""
import json
import types

import jax
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.configs as rconfigs
from repro.models import build_model as r_build_model
from repro.runtime import AutotuneConfig as RAutotuneConfig
from repro.runtime import synthetic_probe as r_synthetic_probe

import repro_torch.api as api
import repro_torch.configs as tconfigs
import repro_torch.core.ccr as ccr_mod
import repro_torch.obs as obs
from repro_torch.interop import params_from_jax
from repro_torch.runtime import AutotuneConfig, synthetic_probe

torch.set_num_threads(2)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("world", [1, 8, 64])
@pytest.mark.parametrize("interval", ["auto", 4])
def test_resolve_interval_equals_reference(reduced, world, interval):
    get = "get_reduced" if reduced else "get_config"
    kw = dict(global_batch=8, seq_len=1024 if not reduced else 32, dp_world=world)
    want = rapi.resolve_interval(interval, getattr(rconfigs, get)("gpt2-paper"), **kw)
    got = api.resolve_interval(interval, getattr(tconfigs, get)("gpt2-paper"), **kw)
    assert got.__dict__ == want.__dict__


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("world", [1, 8, 64])
@pytest.mark.parametrize("compressor,sync", [("covap", "allreduce"), ("covap", "sharded"),
                                             ("fp16", "allreduce"),
                                             ("fp8wire", "allreduce"),
                                             ("powersgd", "allreduce")])
def test_plan_report_equals_reference(reduced, world, compressor, sync):
    kw = dict(reduced=reduced, compressor=compressor, dp_workers=world, sync=sync)
    want = rapi.plan_report("gpt2-paper", **kw)
    got = api.plan_report("gpt2-paper", **kw)
    assert got == want


def test_plan_report_with_an_explicit_interval_equals_reference():
    kw = dict(reduced=False, interval=4, seq_len=1024, bucket_bytes=25 << 20,
              max_buckets=128)
    assert api.plan_report("gpt2-paper", **kw) == rapi.plan_report("gpt2-paper", **kw)


FIT = dict(reduced=True, interval="auto", steps=3, log_every=1, seq_len=16,
           global_batch=4, vocab_size=128)


def test_fit_picks_the_reference_interval_and_matches_its_losses():
    want = rapi.fit("gpt2-paper", **FIT)
    cfg = rconfigs.get_reduced("gpt2-paper").with_(vocab_size=128)
    init = jax.tree.map(np.asarray, r_build_model(cfg).init(jax.random.PRNGKey(0)))
    for overlap in ("post", "fused"):
        got = api.fit("gpt2-paper", device="cpu", init=params_from_jax(init, device="cpu"),
                      overlap=overlap, **FIT)
        assert (got.interval, got.ccr) == (want.interval, want.ccr)
        assert got.final_interval == want.final_interval
        assert [s.summary() for s in got.schedules] == [s.summary() for s in want.schedules]
        np.testing.assert_allclose([h["loss"] for h in got.history],
                                   [h["loss"] for h in want.history], rtol=1e-5)
        assert got.final_loss == got.history[-1]["loss"]
        assert got.state["step"] == 3


def test_fit_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the CPU default check does not apply")
    with pytest.raises(Exception, match="(?i)cuda"):
        api.fit("gpt2-paper", **FIT)


@pytest.mark.parametrize("kw", [{"interval": "adaptive", "guards": True},
                                {"autotune": True, "faults": "grad_nan@1"},
                                {"telemetry": "dir", "guards": {"sync_every": 2}},
                                {"guards": True}, {"faults": "grad_nan@1"}])
def test_unported_fit_options_raise(kw, tmp_path):
    """``guards`` and ``faults`` (the resilience runtime), once refused, run
    with or without the adaptive and telemetry options beside them:
    ``FitResult.resilience`` is the runtime's summary, a fault fires once,
    and without guards nothing recovers (the negative control)."""
    args = dict(FIT, **kw)
    if args.get("telemetry") == "dir":
        args["telemetry"] = str(tmp_path / "tel")
    got = api.fit("gpt2-paper", device="cpu", **args)
    s = got.resilience
    assert s == got.trainer.resilience.summary()
    assert ("faults" in s) == ("faults" in kw)
    if "faults" in kw:
        assert s["faults"]["by_kind"] == {"grad_nan": 1}
    if "guards" not in kw:
        assert s["trips"] == s["actions"] == 0
    if "telemetry" in kw:
        got.telemetry.close()


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("world", [1, 8, 64])
def test_resolve_interval_adaptive_equals_reference(reduced, world):
    get = "get_reduced" if reduced else "get_config"
    kw = dict(global_batch=8, seq_len=1024 if not reduced else 32, dp_world=world)
    want = rapi.resolve_interval("adaptive", getattr(rconfigs, get)("gpt2-paper"), **kw)
    got = api.resolve_interval("adaptive", getattr(tconfigs, get)("gpt2-paper"), **kw)
    assert got.__dict__ == want.__dict__
    assert got == api.resolve_interval("auto", getattr(tconfigs, get)("gpt2-paper"), **kw)


TUNE_EXACT = ("compressor", "options", "mean_bytes_per_step", "volume_ratio",
              "data_dependency", "num_phases", "analytic_ccr")
TUNE_CLOSE = ("speedup", "efficiency", "overlap_frac_modeled", "pack_overhead_us")


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("world", [1, 8, 64])
@pytest.mark.parametrize("arena", [False, True])
def test_tune_equals_reference(reduced, world, arena):
    kw = dict(reduced=reduced, dp_workers=world, arena=arena)
    if not reduced:
        kw.update(seq_len=1024, bucket_bytes=25 << 20, max_buckets=128)
    want = rapi.tune("gpt2-paper", **kw)
    got = api.tune("gpt2-paper", **kw)
    assert [r["compressor"] for r in got] == [r["compressor"] for r in want]
    assert len(got) == len(api._TUNE_CANDIDATES) == len(rapi._TUNE_CANDIDATES)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert {k: g[k] for k in TUNE_EXACT} == {k: w[k] for k in TUNE_EXACT}
        for k in TUNE_CLOSE:
            assert g[k] == pytest.approx(w[k], rel=1e-9, abs=0), (g["compressor"], k)


def test_tune_measured_on_the_cpu_and_its_telemetry(tmp_path):
    tel = obs.Telemetry(str(tmp_path / "tel"))
    rows = api.tune("gpt2-paper", dp_workers=8, measured=True, measure_steps=1,
                    candidates=(("covap", {}), ("none", {})), device="cpu",
                    telemetry=tel)
    tel.close()
    assert [r["compressor"] for r in rows] == [
        r["compressor"] for r in rapi.tune("gpt2-paper", dp_workers=8,
                                           candidates=(("covap", {}), ("none", {})))]
    for r in rows:
        assert np.isfinite(r["measured_ccr"]) and r["measured_interval"] >= 1
        assert r["overlap_frac_achieved"] is None or 0.0 <= r["overlap_frac_achieved"] <= 1.0
    with open(tmp_path / "tel" / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert [e["kind"] for e in events] == ["tune_row", "tune_row"]
    assert all(obs.validate_event(e) == [] for e in events)
    snap = tel.registry.snapshot()
    assert snap['tune_speedup{compressor="covap"}'] == rows[0]["speedup"] or \
        snap['tune_speedup{compressor="covap"}'] == rows[1]["speedup"]


def test_tune_measured_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the CPU default check does not apply")
    with pytest.raises(Exception, match="(?i)cuda"):
        api.tune("gpt2-paper", measured=True, candidates=(("none", {}),))


ADAPTIVE = dict(reduced=True, interval="adaptive", steps=4, log_every=1, seq_len=16,
                global_batch=4, vocab_size=128)
ADAPTIVE_CFG = dict(measure_every=1, warmup_steps=1, window=1, patience=1,
                    cooldown_steps=2)


def test_fit_adaptive_replans_like_the_reference():
    want = rapi.fit("gpt2-paper", autotune=RAutotuneConfig(
        probe=r_synthetic_probe(0.01, 2.5), **ADAPTIVE_CFG), **ADAPTIVE)
    cfg = rconfigs.get_reduced("gpt2-paper").with_(vocab_size=128)
    init = jax.tree.map(np.asarray, r_build_model(cfg).init(jax.random.PRNGKey(0)))
    got = api.fit("gpt2-paper", device="cpu", init=params_from_jax(init, device="cpu"),
                  autotune=AutotuneConfig(probe=synthetic_probe(0.01, 2.5), **ADAPTIVE_CFG),
                  **ADAPTIVE)
    assert (got.interval, got.ccr) == (want.interval, want.ccr) and got.interval == 64
    assert got.final_interval == want.final_interval == 3
    for key in ("interval", "replans", "measured_ccr", "breaker_open"):
        assert got.autotune[key] == want.autotune[key]
    assert got.autotune["transitions"][0]["policy"] == \
        want.autotune["transitions"][0]["policy"]
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in want.history], rtol=1e-5)
    assert got.telemetry is None


class PinnedClock:
    """``time.perf_counter`` as ``repro_torch.core.ccr`` reads it: the k-th
    interval ``measure_ccr`` times lasts ``durations[k % 3]`` (its full,
    compute-only and schedule-only programs, in that order), whatever the
    machine's load."""

    def __init__(self, durations):
        self.durations, self.now, self.reads = durations, 0.0, 0

    def perf_counter(self):
        if self.reads % 2:
            self.now += self.durations[(self.reads // 2) % len(self.durations)]
        self.reads += 1
        return self.now


def test_fit_adaptive_arms_the_real_probe_and_telemetry(tmp_path, monkeypatch):
    got = api.fit("gpt2-paper", device="cpu", interval="adaptive", steps=2, log_every=1,
                  seq_len=16, global_batch=4, vocab_size=128,
                  telemetry=str(tmp_path / "tel"))
    assert got.autotune is not None and got.trainer.runtime is not None
    assert got.autotune["replans"] == 0 and got.autotune["measured_ccr"] is None
    assert isinstance(got.telemetry, obs.Telemetry)
    got.telemetry.close()
    # one worker: the measured comm is about 0, so two probes (the default
    # patience) re-plan I = 4 to 1, where EF is off and the residual is
    # dropped (the reference's rule, its test_transition_reinit_...).  The
    # real PhaseProbe runs its three programs; the times it reads are pinned
    # to a one-worker decomposition (full = compute-only, schedule-only at
    # the launch floor), so that a loaded machine cannot move the CCR
    clock = PinnedClock((2e-3, 2e-3, 1e-5))
    monkeypatch.setattr(ccr_mod, "time", types.SimpleNamespace(perf_counter=clock.perf_counter))
    one = api.fit("gpt2-paper", device="cpu", interval=4, steps=2, seq_len=16,
                  global_batch=4, vocab_size=128, autotune=AutotuneConfig(
                      measure_every=1, warmup_steps=0, probe_warmup=0, probe_iters=1))
    assert clock.reads == 2 * 6            # two probes, three timed programs each
    assert one.interval == 4 and one.final_interval == 1
    (rep,) = one.autotune["transitions"]
    assert (rep["old_interval"], rep["new_interval"], rep["policy"]) == (4, 1, "reinit")
    assert rep["norm_before"] > 0 == rep["norm_after"]
    assert one.state["comp"] == ()
