"""The port's COVAP ``SyncPipeline.execute`` against
``repro.core.get_compressor("covap", interval=4).execute`` (one worker) on
the same gradients and residuals, for every phase of a cycle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.core import get_compressor as r_get_compressor
from repro.models import build_model as r_build_model

import repro_torch.configs as tconfigs
from repro_torch.core import build_plan, get_compressor
from repro_torch.core.error_feedback import EFSchedule
from repro_torch.core.stages import ErrorFeedback, SyncPipeline, WireCast
from repro_torch.models import build_model

torch.set_num_threads(2)

PLAN_KW = dict(bucket_bytes=1 << 14, max_buckets=32, interval=4)


def _setup(seed=0):
    rcfg = rconfigs.get_reduced("gpt2-paper")
    shapes = jax.eval_shape(r_build_model(rcfg).init, jax.random.PRNGKey(0))
    rplan = r_build_plan(shapes, **PLAN_KW)
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="meta")
    plan = build_plan(model.named_leaves(), **PLAN_KW)
    rng = np.random.default_rng(seed)
    grads = [rng.standard_normal(s).astype(np.float32) for s in plan.leaf_shapes]
    resid = [rng.standard_normal(s).astype(np.float32) for s in plan.leaf_shapes]
    treedef = jax.tree_util.tree_structure(shapes)
    return rplan, plan, grads, resid, treedef


def _assert_ef_close(got, want, r, c):
    atol = 1e-6 * float(np.max(np.abs(c * r)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 405])
def test_execute_matches_reference_per_phase(step):
    rplan, plan, grads, resid, treedef = _setup()
    assert plan.num_buckets == rplan.num_buckets > 4
    rcomp = r_get_compressor("covap", interval=4)
    comp = get_compressor("covap", interval=4)
    phase = step % 4
    rs = rcomp.plan_phase(rplan, phase)
    s = comp.plan_phase(plan, phase)
    assert s.selected == rs.selected
    unflat = lambda xs: jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in xs])
    rout, rstate, rstats = rcomp.execute(rs, unflat(grads), unflat(resid), step=step)
    g_t = [torch.from_numpy(g) for g in grads]
    r_t = [torch.from_numpy(r) for r in resid]
    out, state, stats = comp.execute(s, g_t, r_t, step=step)
    assert stats.bytes_per_worker == rstats.bytes_per_worker
    c = comp.ef_coefficient(step)
    assert c == pytest.approx(float(rcomp.ef.schedule.coefficient(step)))
    for a, b, r in zip(out, jax.tree_util.tree_leaves(rout), resid):
        _assert_ef_close(a.numpy(), np.asarray(b), r, c)
    for a, b, r in zip(state, jax.tree_util.tree_leaves(rstate), resid):
        _assert_ef_close(a.numpy(), np.asarray(b), r, c)
    # inputs are left untouched
    assert all(np.array_equal(t.numpy(), g) for t, g in zip(g_t, grads))
    assert all(np.array_equal(t.numpy(), r) for t, r in zip(r_t, resid))


def test_every_element_sent_once_per_cycle():
    """Over one cycle each element goes out exactly once and the residual of
    a selected bucket is zeroed (the filter's partition property)."""
    _, plan, grads, _, _ = _setup(seed=1)
    comp = get_compressor("covap", interval=4)
    sent = [torch.zeros(s) for s in plan.leaf_shapes]
    for phase in range(4):
        out, state, _ = comp.execute(
            comp.plan_phase(plan, phase),
            [torch.from_numpy(g) for g in grads],
            [torch.zeros(s) for s in plan.leaf_shapes], step=phase,
        )
        for acc, o, r in zip(sent, out, state):
            assert torch.all((o == 0) | (r == 0))
            acc += (o != 0).float()
    assert all(torch.all(a == 1) for a in sent)


@pytest.mark.parametrize("step", [0, 199, 200, 1234, 10_000])
def test_ef_coefficient_matches_reference(step):
    from repro.core.error_feedback import EFSchedule as REFSchedule

    assert EFSchedule().coefficient(step) == float(REFSchedule().coefficient(step))


def test_kernel_opt_in_raises_on_cpu_and_opt_out_runs():
    _, plan, grads, resid, _ = _setup()
    g_t = [torch.from_numpy(g) for g in grads]
    r_t = [torch.from_numpy(r) for r in resid]
    comp = get_compressor("covap", interval=4, use_ef_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        comp.execute(comp.plan_phase(plan, 0), g_t, r_t, step=0)
    off = get_compressor("covap", interval=4, use_ef_kernel=False)
    auto = get_compressor("covap", interval=4)
    a, ra, _ = off.execute(off.plan_phase(plan, 1), g_t, r_t, step=1)
    b, rb, _ = auto.execute(auto.plan_phase(plan, 1), g_t, r_t, step=1)
    assert all(torch.equal(x, y) for x, y in zip(a + ra, b + rb))


def test_interval_one_is_a_dense_mean_without_ef():
    _, plan, grads, _, _ = _setup()
    comp = get_compressor("covap", interval=1)
    assert comp.ef is None and comp.num_phases() == 1
    g_t = [torch.from_numpy(g) for g in grads]
    out, state, _ = comp.execute(comp.plan_phase(plan, 0), g_t, (), step=0)
    assert state == ()
    assert all(torch.equal(o, g) for o, g in zip(out, g_t))


def test_error_feedback_default_is_classic_ef():
    """``ErrorFeedback()`` is the baselines' classic EF, as in the reference
    (``schedule=None``, coefficient 1, ``t = g + r``); with a schedule it
    compensates with the schedule's coefficient (COVAP)."""
    from repro.core.stages import ErrorFeedback as RErrorFeedback
    from repro.core.stages import SyncPipeline as RSyncPipeline
    from repro.core.stages import WireCast as RWireCast

    assert ErrorFeedback().schedule is None and RErrorFeedback().schedule is None
    pipe = SyncPipeline(wire=WireCast(), ef=ErrorFeedback())
    rpipe = RSyncPipeline(wire=RWireCast(), ef=RErrorFeedback())
    for step in (0, 5, 10_000):
        assert pipe.ef_coefficient(step) == float(rpipe.ef_coefficient(step)) == 1.0
    _, plan, grads, resid, treedef = _setup(seed=4)
    g_t = [torch.from_numpy(g) for g in grads]
    r_t = [torch.from_numpy(r) for r in resid]
    unflat = lambda xs: jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in xs])
    want = jax.tree_util.tree_leaves(
        RErrorFeedback().compensated(unflat(grads), unflat(resid), 3))
    got = ErrorFeedback().compensated(g_t, r_t, 3)
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(got, want))
    assert all(torch.equal(a, g + r) for a, g, r in zip(got, g_t, r_t))
    sched = ErrorFeedback(EFSchedule())
    assert all(torch.equal(a, g + np.float32(0.3) * r)
               for a, g, r in zip(sched.compensated(g_t, r_t, 3), g_t, r_t))
    assert SyncPipeline(wire=WireCast(), ef=sched).ef_coefficient(3) == float(np.float32(0.3))
    assert get_compressor("covap", interval=4).ef.schedule == EFSchedule()
