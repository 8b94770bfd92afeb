"""The port's CCR (``core/ccr.py``) and parameter count against
``repro.core.ccr`` and ``repro.models.count_params``: the same numbers on
the same inputs, with the hardware passed explicitly (the port's spec is
the paper's V100 + 30 Gbps environment, and it carries no TPU figure).
The measured profiler ``measure_ccr`` is held against the reference's
under a fake clock, never the wall clock."""
import dataclasses
import types

import jax
import pytest

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.core import ccr as rccr
from repro.core import get_compressor as r_get_compressor
from repro.core.schedule import plan_all_phases as r_plan_all_phases
from repro.models import build_model as r_build_model
from repro.models import count_params as r_count_params

import repro_torch.configs as tconfigs
from repro_torch.core import build_plan, ccr, get_compressor
from repro_torch.core.schedule import plan_all_phases
from repro_torch.models import build_model, count_params

V100 = ccr.HardwareSpec.cloud_v100_30gbps()
R_V100 = rccr.HardwareSpec.cloud_v100_30gbps()
OTHER = ccr.HardwareSpec(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9, mfu=0.5)
R_OTHER = rccr.HardwareSpec(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9, mfu=0.5)


def test_hardware_spec_is_the_papers_and_holds_no_tpu_figure():
    fields = {f.name for f in dataclasses.fields(ccr.HardwareSpec)}
    assert fields == {"peak_flops", "hbm_bw", "ici_bw", "mfu", "dcn_bw"}
    for name in fields - {"dcn_bw"}:
        assert getattr(V100, name) == getattr(R_V100, name)
    # the paper's network between nodes is the same 30 Gbps Ethernet; the
    # reference's spec inherits its TPU v5e DCN default (a known difference)
    assert V100.dcn_bw == V100.ici_bw and R_V100.dcn_bw == 6.25e9
    assert not hasattr(ccr.HardwareSpec, "v5e")
    with pytest.raises(TypeError):
        ccr.HardwareSpec()                     # no defaults to fall back on


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_count_params_equals_reference(reduced):
    get = "get_reduced" if reduced else "get_config"
    rcfg, tcfg = getattr(rconfigs, get)("gpt2-paper"), getattr(tconfigs, get)("gpt2-paper")
    for active in (False, True):
        assert count_params(tcfg, active_only=active) == r_count_params(rcfg, active)
    if not reduced:
        assert count_params(tcfg) == 190_532_352


@pytest.mark.parametrize("hw", ["v100", "other"])
@pytest.mark.parametrize("world", [1, 2, 8, 64])
@pytest.mark.parametrize("flops,grad_bytes", [(3.4e12, 7.6e8), (1e15, 7.6e8),
                                              (2.2e9, 1.8e6)])
def test_analytic_times_and_ccr_equal_reference(hw, world, flops, grad_bytes):
    spec, rspec = (V100, R_V100) if hw == "v100" else (OTHER, R_OTHER)
    kw = dict(step_flops_per_chip=flops, grad_bytes=grad_bytes, dp_world=world)
    assert ccr.analytic_times(hw=spec, **kw) == rccr.analytic_times(hw=rspec, **kw)
    assert ccr.analytic_ccr(hw=spec, **kw) == rccr.analytic_ccr(hw=rspec, **kw)
    assert ccr.allreduce_bytes_on_wire(grad_bytes, world) == \
        rccr.allreduce_bytes_on_wire(grad_bytes, world)
    # the port's fallback is the paper's spec
    assert ccr.analytic_ccr(**kw) == rccr.analytic_ccr(hw=R_V100, **kw)


@pytest.mark.parametrize("value", [0.0, 0.3, 1.0, 1.0001, 3.9, 4.0, 63.2, 64.0, 1e4])
def test_select_interval_equals_reference(value):
    for cap in (64, 8):
        assert ccr.select_interval(value, cap) == rccr.select_interval(value, cap)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("name,opts", [("covap", {"interval": 4}),
                                       ("covap", {"interval": 4, "sync": "sharded"}),
                                       ("none", {}), ("fp16", {}), ("fp8wire", {}),
                                       ("efsignsgd", {}), ("powersgd", {})])
@pytest.mark.parametrize("world", [1, 8, 64])
def test_compressed_ccr_equals_reference(reduced, name, opts, world):
    get = "get_reduced" if reduced else "get_config"
    shapes = jax.eval_shape(r_build_model(getattr(rconfigs, get)("gpt2-paper")).init,
                            jax.random.PRNGKey(0))
    rplan = r_build_plan(shapes)
    plan = build_plan(build_model(getattr(tconfigs, get)("gpt2-paper"),
                                  device="meta").named_leaves())
    rs = r_plan_all_phases(r_get_compressor(name, **opts), rplan, world=world)
    ts = plan_all_phases(get_compressor(name, **opts), plan, world=world)
    assert len(ts) == len(rs)
    for t_comp in (1e-3, 0.25):
        assert ccr.schedule_comm_seconds(ts, world=world, hw=V100) == \
            rccr.schedule_comm_seconds(rs, world=world, hw=R_V100)
        assert ccr.compressed_ccr(ts, t_comp=t_comp, world=world, hw=OTHER) == \
            rccr.compressed_ccr(rs, t_comp=t_comp, world=world, hw=R_OTHER)
        assert ccr.compressed_ccr(ts, t_comp=t_comp, world=world, link_bw=1e9,
                                  hw=V100) == \
            rccr.compressed_ccr(rs, t_comp=t_comp, world=world, link_bw=1e9, hw=R_V100)


class FakeClock:
    """``time.perf_counter`` as the module sees it; each step callable
    advances it by its own duration."""

    def __init__(self):
        self.now = 0.0
        self.calls = {}

    def perf_counter(self):
        return self.now

    def step(self, name, dt):
        def run():
            self.now += dt
            self.calls[name] = self.calls.get(name, 0) + 1
        return run


@pytest.mark.parametrize("full,comp,comm", [(0.3, 0.2, None), (0.2, 0.25, None),
                                            (0.3, 0.2, 0.15), (0.3, 0.2, 0.05),
                                            (0.125, 0.0, 0.0)])
@pytest.mark.parametrize("warmup,iters", [(0, 1), (2, 5), (1, 2)])
def test_measure_ccr_under_a_fake_clock_equals_reference(monkeypatch, full, comp, comm,
                                                         warmup, iters):
    results = []
    for mod in (ccr, rccr):
        clock = FakeClock()
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(perf_counter=clock.perf_counter))
        comm_only = None if comm is None else clock.step("comm", comm)
        res = mod.measure_ccr(clock.step("full", full), clock.step("comp", comp),
                              step_comm_only=comm_only, warmup=warmup, iters=iters)
        assert clock.calls == {k: warmup + iters for k in ("full", "comp", "comm")
                               if k != "comm" or comm is not None}
        results.append(res)
    got, want = results
    assert got == want
    assert set(got) == ({"t_full", "t_comp", "t_comm", "ccr"}
                        | ({"t_comm_direct"} if comm is not None else set()))
    assert got["t_full"] == pytest.approx(full) and got["t_comp"] == pytest.approx(comp)
    t_comm = max(full - comp, 0.0, comm or 0.0)
    assert got["t_comm"] == pytest.approx(t_comm)
    assert got["ccr"] == pytest.approx(t_comm / max(comp, 1e-12))
