"""The port's library surface (``repro_torch.api``) against ``repro.api``:
``resolve_interval`` and ``plan_report`` give the reference's values on
gpt2-paper (REDUCED and full width, 1, 8 and 64 modelled workers), and
``fit(interval="auto")`` picks the reference's interval and trains within
the trainer tests' tolerance of the reference's ``fit``.  What is not
ported raises ``NotImplementedError``."""
import jax
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.configs as rconfigs
from repro.models import build_model as r_build_model

import repro_torch.api as api
import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_jax

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


@pytest.mark.parametrize("kw", [{"interval": "adaptive"}, {"autotune": True},
                                {"telemetry": "dir"}, {"guards": True},
                                {"faults": "grad_nan@1"}])
def test_unported_fit_options_raise(kw):
    args = dict(FIT, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        api.fit("gpt2-paper", device="cpu", **args)
