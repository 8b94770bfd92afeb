"""The port's perf model (``repro_torch.core.perfmodel``) against
``repro.core.perfmodel``: every function on the same floats (made from a
numpy seed) and on the same plans' schedules gives the same result, bit
for bit, since both are plain float arithmetic in the same order.

The schedules come from both packages' compressors over the REDUCED and the
full-width gpt2-paper bucket plans, at 1, 2 and 8 modelled workers, with
every compressor the port has, and COVAP's sharded form."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.core import get_compressor as r_get_compressor
from repro.core import perfmodel as rpm
from repro.core.schedule import plan_all_phases as r_plan_all_phases
from repro.models import build_model as r_build_model

import repro_torch.configs as tconfigs
from repro_torch.core import build_plan, get_compressor
from repro_torch.core import perfmodel as pm
from repro_torch.core.schedule import plan_all_phases
from repro_torch.models import build_model

PLAN_KW = dict(bucket_bytes=1 << 14, max_buckets=32)
COMPRESSORS = [
    ("covap", {"interval": 4}),
    ("covap", {"interval": 4, "sync": "sharded"}),
    ("covap", {"interval": 1}),
    ("none", {}),
    ("fp16", {}),
    ("fp8wire", {}),
    ("efsignsgd", {}),
    ("powersgd", {"rank": 2}),
    ("topk", {"ratio": 0.01}),
    ("randomk", {"ratio": 0.01}),
    ("dgc", {"ratio": 0.01}),
    ("oktopk", {"ratio": 0.01}),
]


def _floats(seed, n):
    return [float(x) for x in np.random.default_rng(seed).uniform(1e-3, 2.0, n)]


@pytest.mark.parametrize("seed", range(4))
def test_closed_forms_equal_reference(seed):
    tb, tc, tm, tz = _floats(seed, 4)
    P = int(np.random.default_rng(seed).integers(1, 65))
    assert pm.t_dp(tb, tc, tm) == rpm.t_dp(tb, tc, tm)
    assert pm.speedup_dp(P, tb, tc, tm) == rpm.speedup_dp(P, tb, tc, tm)
    for n in (1, 3, 8):
        assert pm.t_ovlp(tb, tc, tm, n) == rpm.t_ovlp(tb, tc, tm, n)
        assert pm.t_gc_ovlp(tb, tc, tm, tz, n) == rpm.t_gc_ovlp(tb, tc, tm, tz, n)
        assert pm.t_gc_ovlp(tb, tc, tm, tz, n, data_dependency=True) == \
            rpm.t_gc_ovlp(tb, tc, tm, tz, n, data_dependency=True)
    assert pm.speedup_ovlp(P, tb, tc, tm) == rpm.speedup_ovlp(P, tb, tc, tm)
    assert pm.t_gc(tb, tc, tm, tz) == rpm.t_gc(tb, tc, tm, tz)
    for dd in (False, True):
        kw = dict(volume_ratio=4.0 + seed, t_compress=tz, data_dependency=dd, n_buckets=5)
        assert pm.speedup_gc_ovlp(P, tb, tc, tm, **kw) == \
            rpm.speedup_gc_ovlp(P, tb, tc, tm, **kw)
    assert pm.achieved_overlap_fraction(tc, tm, tb + tc) == \
        rpm.achieved_overlap_fraction(tc, tm, tb + tc)
    assert pm.achieved_overlap_fraction(tc, 0.0, tb) == 1.0 == \
        rpm.achieved_overlap_fraction(tc, 0.0, tb)


@pytest.mark.parametrize("seed", range(4))
def test_simulate_overlap_and_overlap_fraction_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    comp = [float(x) for x in rng.uniform(0, 1, n)]
    comm = [float(x) if rng.random() > 0.3 else 0.0 for x in rng.uniform(0, 2, n)]
    got = pm.simulate_overlap(0.25, comp, comm)
    assert got == rpm.simulate_overlap(0.25, comp, comm)
    assert pm.overlap_fraction(got) == rpm.overlap_fraction(got)
    assert pm.overlap_fraction({}) == rpm.overlap_fraction({}) == 1.0


@pytest.mark.parametrize("world", [1, 2, 8, 64])
@pytest.mark.parametrize("allgather", [False, True])
def test_scheme_profile_equals_reference(world, allgather):
    kw = dict(name="x", volume_ratio=3.0, compress_overhead_frac=0.1,
              allgather_based=allgather)
    assert pm.SchemeProfile(**kw).comm_scale(world) == \
        rpm.SchemeProfile(**kw).comm_scale(world)


def _plans(reduced, interval):
    cfg = (rconfigs.get_reduced if reduced else rconfigs.get_config)("gpt2-paper")
    shapes = jax.eval_shape(r_build_model(cfg).init, jax.random.PRNGKey(0))
    model = build_model((tconfigs.get_reduced if reduced else tconfigs.get_config)
                        ("gpt2-paper"), device="meta")
    kw = PLAN_KW if reduced else dict(bucket_bytes=25 << 20, max_buckets=128)
    return (r_build_plan(shapes, interval=interval, **kw),
            build_plan(model.named_leaves(), interval=interval, **kw))


@pytest.fixture(scope="module")
def plans():
    return {(reduced, i): _plans(reduced, i) for reduced in (True, False) for i in (1, 4)}


def _schedules(plans, reduced, name, opts, world):
    rplan, plan = plans[(reduced, opts.get("interval", 4))]
    return (r_plan_all_phases(r_get_compressor(name, **opts), rplan, world=world),
            plan_all_phases(get_compressor(name, **opts), plan, world=world),
            get_compressor(name, **opts))


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("world", [1, 2, 8])
@pytest.mark.parametrize("name,opts", COMPRESSORS,
                         ids=["-".join([n, *map(str, o.values())]) for n, o in COMPRESSORS])
def test_schedule_functions_equal_reference(plans, reduced, world, name, opts):
    rscheds, scheds, comp = _schedules(plans, reduced, name, opts, world)
    assert len(scheds) == len(rscheds)
    bw = 3.75e9
    ef = getattr(comp, "ef", None) is not None
    for s, r in zip(scheds, rscheds):
        for link_bw in (bw, {"ici": bw}):
            assert pm.schedule_comm_times(s, world=world, link_bw=link_bw) == \
                rpm.schedule_comm_times(r, world=world, link_bw=link_bw)
        for e in (False, True):
            assert pm.pack_overhead_s(s, hbm_bw=9e11, ef=e) == \
                rpm.pack_overhead_s(r, hbm_bw=9e11, ef=e)
        t_pack = pm.pack_overhead_s(s, hbm_bw=9e11, ef=ef)
        for kw in (dict(), dict(ready_order=True), dict(t_compress=0.003, t_pack=t_pack),
                   dict(data_dependency=True), dict(ready_order=True, t_pack=t_pack)):
            for link_bw in (bw, {"ici": bw}):
                assert pm.simulate_schedule(0.01, 0.02, s, world=world, link_bw=link_bw,
                                            **kw) == \
                    rpm.simulate_schedule(0.01, 0.02, r, world=world, link_bw=link_bw,
                                          **kw)
    for dd in (False, True):
        kw = dict(world=world, link_bw=bw, t_compress=0.001, data_dependency=dd)
        assert pm.cycle_speedup(world, 0.01, 0.02, scheds, **kw) == \
            rpm.cycle_speedup(world, 0.01, 0.02, rscheds, **kw)


def test_schedule_comm_times_names_a_missing_link(plans):
    _, scheds, _ = _schedules(plans, True, "none", {}, 2)
    with pytest.raises(KeyError, match="no bandwidth for link 'ici'"):
        pm.schedule_comm_times(scheds[0], world=2, link_bw={"nvlink": 1e9})


def test_pack_overhead_reads_wire_itemsize_without_numpy_dtypes(plans):
    """The reference reads the wire's itemsize through numpy (bfloat16 and
    float8 are numpy dtypes once JAX is imported); the port reads torch's,
    with the same values."""
    for name in ("float32", "bfloat16", "float16", "float8_e4m3fn", "int8"):
        assert getattr(torch, name).itemsize == np.dtype(getattr(jax.numpy, name)).itemsize
