"""The port's flat-bucket sync path (``fp8wire`` and ``efsignsgd``) against
``repro.core``'s, on the gpt2-paper shapes, one worker.

* ``SyncPipeline.execute`` against the reference's ``execute`` (eager on the
  CPU) on the same gradients and residuals from a numpy seed: the FP8 wire
  bit for bit, the sign wire with its signs bit for bit and its scale at
  rtol 1e-6.
* The arena form equals the per-bucket form bit for bit.
* The static schedules (bytes per worker, volume ratio) equal the
  reference's at full width for W = 1 and 8.
* ``sync="sharded"`` with a flat wire raises, as in the reference.
"""
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
from repro_torch.core.overlap import supports_sharded_sync
from repro_torch.models import build_model

torch.set_num_threads(2)

PLAN_KW = dict(bucket_bytes=1 << 14, max_buckets=32, interval=4)
CASES = [
    ("fp8wire", {}),
    ("fp8wire", {"block": 64}),
    ("fp8wire", {"ef": False}),
    ("efsignsgd", {}),
    ("efsignsgd", {"ef": False}),
]
CASE_IDS = ["fp8wire", "fp8wire-block64", "fp8wire-no-ef", "efsignsgd",
            "efsignsgd-no-ef"]
# full-width gpt2-paper, one phase: every bucket every step
FULL_WIDTH_BYTES = {"fp8wire": 190_625_408, "efsignsgd": 190_532_492}


def _plans(reduced=True, **kw):
    get = "get_reduced" if reduced else "get_config"
    shapes = jax.eval_shape(r_build_model(getattr(rconfigs, get)("gpt2-paper")).init,
                            jax.random.PRNGKey(0))
    rplan = r_build_plan(shapes, **kw)
    plan = build_plan(build_model(getattr(tconfigs, get)("gpt2-paper"),
                                  device="meta").named_leaves(), **kw)
    return rplan, plan, jax.tree_util.tree_structure(shapes)


def _tensors(plan, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in plan.leaf_shapes]


def _execute_port(name, kw, plan, grads, resid, step, **opts):
    comp = get_compressor(name, **kw, **opts)
    s = comp.plan_phase(plan, 0)
    state = [torch.from_numpy(r) for r in resid] if comp.ef is not None else ()
    out, new_state, stats = comp.execute(
        s, [torch.from_numpy(g) for g in grads], state, step=step)
    return comp, s, out, new_state, stats


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("name,kw", CASES, ids=CASE_IDS)
def test_flat_execute_matches_reference(name, kw, step):
    """Classic EF (``t = g + r``), each bucket concatenated, encoded,
    gathered (W=1) and decoded, residual ``t - sent``.  FP8: the eager
    reference divides as the port does, so synced values and residuals are
    equal bit for bit.  Sign: the signs of the synced values are equal bit
    for bit; the scale ``mean|t|`` sums in another order, so synced values
    are held at rtol 1e-6, and residuals at atol 1e-6 of the leaf's largest
    synced value (``t - sent`` moves by the scale's difference) plus rtol
    1e-6 (where ``|t|`` is far above the scale, ``t - sent`` rounds at
    ``t``'s ulp)."""
    rplan, plan, treedef = _plans(**PLAN_KW)
    grads, resid = _tensors(plan, 10 + step), _tensors(plan, 20 + step, 0.1)
    comp, s, out, state, stats = _execute_port(name, kw, plan, grads, resid, step)
    rcomp = r_get_compressor(name, **kw)
    rs = rcomp.plan_phase(rplan, 0)
    assert s.selected == rs.selected == tuple(range(plan.num_buckets))
    assert stats.bytes_per_worker == rs.bytes_per_worker
    unflat = lambda xs: jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in xs])
    rout, rstate, _ = rcomp.execute(
        rs, unflat(grads), unflat(resid) if rcomp.ef is not None else (), step=step)
    rout = [np.asarray(x) for x in jax.tree_util.tree_leaves(rout)]
    if comp.ef is None:
        assert state == () and rstate == ()
        rstate = []
    else:
        rstate = [np.asarray(x) for x in jax.tree_util.tree_leaves(rstate)]
    for a, b in zip(out, rout):
        if name == "fp8wire":
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_array_equal(np.sign(a.numpy()), np.sign(b))
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6)
    for a, b, o in zip(state, rstate, rout):
        if name == "fp8wire":
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-6 * float(np.max(np.abs(o))))


@pytest.mark.parametrize("step", [0, 1, 5])
@pytest.mark.parametrize("name,kw", CASES, ids=CASE_IDS)
def test_flat_arena_equals_per_bucket_bitwise(name, kw, step):
    """``use_arena=True`` packs the compensated tree into planes and runs
    each wire stage on its slot view; the result is the concatenation
    form's, bit for bit (as the reference asserts in
    ``tests/test_arena.py``)."""
    _, plan, _ = _plans(**PLAN_KW)
    grads, resid = _tensors(plan, 30 + step), _tensors(plan, 40 + step, 0.1)
    _, _, out, state, _ = _execute_port(name, kw, plan, grads, resid, step)
    _, _, aout, astate, _ = _execute_port(name, kw, plan, grads, resid, step,
                                          use_arena=True)
    assert all(torch.equal(a, b) for a, b in zip(aout, out))
    assert all(torch.equal(a, b) for a, b in zip(astate, state))
    # inputs are left untouched
    assert all(np.array_equal(g, _tensors(plan, 30 + step)[i])
               for i, g in enumerate(grads))


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("name", ["fp8wire", "efsignsgd"])
def test_full_width_flat_schedule_equals_reference(name, world):
    rplan, plan, _ = _plans(reduced=False)
    r = r_get_compressor(name).plan_phase(rplan, 0, world=world)
    p = get_compressor(name).plan_phase(plan, 0, world=world)
    assert p.num_phases == r.num_phases == 1
    assert p.selected == r.selected
    assert p.bytes_per_worker == r.bytes_per_worker == FULL_WIDTH_BYTES[name]
    assert p.volume_ratio == pytest.approx(r.volume_ratio, rel=1e-12)
    assert [(c.target, c.op, c.wire_dtype, c.payload_bytes, c.index_bytes)
            for c in p.calls] == [
        (c.target, c.op, c.wire_dtype, c.payload_bytes, c.index_bytes)
        for c in r.calls]
    assert p.wire_bytes() == pytest.approx(r.wire_bytes())
    assert p.summary() == {k: v for k, v in r.summary().items() if k in p.summary()}


@pytest.mark.parametrize("name", ["fp8wire", "efsignsgd"])
def test_sharded_sync_with_a_flat_wire_raises(name):
    with pytest.raises(ValueError):
        r_get_compressor(name, sync="sharded")
    with pytest.raises(ValueError, match="sync='sharded'"):
        get_compressor(name, sync="sharded")
    assert not supports_sharded_sync(get_compressor(name))


def test_wire_kernel_opt_in_raises_on_cpu_and_opt_out_runs():
    _, plan, _ = _plans(**PLAN_KW)
    grads, resid = _tensors(plan, 50), _tensors(plan, 51)
    for name in ("fp8wire", "efsignsgd"):
        for arena in (False, True):
            with pytest.raises(ValueError, match="CUDA"):
                _execute_port(name, {}, plan, grads, resid, 0, use_arena=arena,
                              use_wire_kernel=True)
        _, _, a, ra, _ = _execute_port(name, {}, plan, grads, resid, 1,
                                       use_wire_kernel=False)
        _, _, b, rb, _ = _execute_port(name, {}, plan, grads, resid, 1)
        assert all(torch.equal(x, y) for x, y in zip(a + ra, b + rb))
