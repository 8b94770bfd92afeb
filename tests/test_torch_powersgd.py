"""The port's PowerSGD (``LowRank`` and the leaf-granularity path of
``SyncPipeline``) against ``repro.core``'s, one worker.

* ``LowRank.execute_leaf`` and ``SyncPipeline.execute`` against the
  reference's eager ``execute_leaf`` / ``execute`` on the same gradients,
  residuals and starting Q (numpy-seeded, the reference's Q carried over by
  ``interop.compressor_state_from_jax``), with EF on and off.  The two
  frameworks' products and QR differ in their last bits (about 1e-7 of
  ``|A| @ |B|``), so values are held at allclose: rtol 1e-5 and atol 1e-5
  of the leaf's largest reference magnitude (of its ``approx`` for a
  residual, which inherits ``approx``'s error).
* The static schedule at full width: 2,528,448 bytes a worker a step in 12
  all-reduces, granularity ``leaf``, for W = 1 and 8.
* The two guards of ``SyncPipeline.__init__``, the all-zero leaf, the
  starting state and the kernel opt-in on CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.core import get_compressor as r_get_compressor
from repro.core.stages import CoarseFilter as RCoarseFilter
from repro.core.stages import LowRank as RLowRank
from repro.core.stages import SyncPipeline as RSyncPipeline
from repro.models import build_model as r_build_model

import repro_torch.configs as tconfigs
from repro_torch.core import build_plan, get_compressor
from repro_torch.core.overlap import supports_sharded_sync
from repro_torch.core.stages import CoarseFilter, LowRank, SyncPipeline
from repro_torch.interop import compressor_state_from_jax
from repro_torch.models import build_model

torch.set_num_threads(2)

FULL_WIDTH_BYTES = 2_528_448
RTOL = 1e-5
ATOL_OF_MAX = 1e-5


def _plans(reduced=True):
    get = "get_reduced" if reduced else "get_config"
    shapes = jax.eval_shape(r_build_model(getattr(rconfigs, get)("gpt2-paper")).init,
                            jax.random.PRNGKey(0))
    rplan = r_build_plan(shapes)
    plan = build_plan(build_model(getattr(tconfigs, get)("gpt2-paper"),
                                  device="meta").named_leaves())
    return shapes, rplan, plan


def _tensors(plan, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in plan.leaf_shapes]


def _assert_close(got, want, err_msg="", scale=None):
    """rtol 1e-5, atol 1e-5 of ``scale`` (default: the largest ``|want|``)."""
    want = np.asarray(want)
    if scale is None:
        scale = float(np.max(np.abs(want))) if want.size else 0.0
    atol = ATOL_OF_MAX * scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=atol,
                               err_msg=err_msg)


def _numpy_state(state):
    return {k: [None if v is None else np.asarray(v) for v in vs]
            for k, vs in state.items()}


@pytest.mark.parametrize("leaf", range(12))
def test_execute_leaf_matches_reference(leaf):
    """One leaf through ``LowRank.execute_leaf`` on the same compensated
    ``t`` and Q: ``(approx, new_q)``, or the dense mean (``new_q`` None)
    for the 1-D final norm."""
    shapes, rplan, plan = _plans()
    t = _tensors(plan, 1)[leaf]
    rq = RLowRank(2).init_state(shapes, rplan, use_ef=False)["q"][leaf]
    q = None if rq is None else torch.from_numpy(np.array(rq))
    approx, qn = LowRank(2).execute_leaf(torch.from_numpy(t), q, None)
    rapprox, rqn = RLowRank(2).execute_leaf(jnp.asarray(t), rq, ())
    assert (qn is None) == (rqn is None) == (len(t.shape) < 2)
    assert approx.shape == t.shape and approx.dtype == torch.float32
    _assert_close(approx.numpy(), rapprox, f"leaf {leaf} approx")
    if qn is not None:
        assert tuple(qn.shape) == tuple(rqn.shape)
        _assert_close(qn.numpy(), rqn, f"leaf {leaf} q")
    else:
        np.testing.assert_array_equal(approx.numpy(), t)


@pytest.mark.parametrize("rank", [1, 2, 4])
@pytest.mark.parametrize("ef", [True, False])
def test_execute_matches_reference(ef, rank):
    """``SyncPipeline.execute`` of ``powersgd`` against the reference's on
    the same gradients, residuals and Q: synced leaves, new Q and
    residuals ``t - approx`` (zeros for the dense leaf; ``None`` entries
    without EF), two steps in a row with the state carried."""
    shapes, rplan, plan = _plans()
    treedef = jax.tree_util.tree_structure(shapes)
    rcomp = r_get_compressor("powersgd", rank=rank, ef=ef)
    comp = get_compressor("powersgd", rank=rank, ef=ef)
    rstate = rcomp.init_state(shapes, rplan)
    resid = _tensors(plan, 2, 0.1)
    if ef:
        rstate = {"q": rstate["q"], "residual": [jnp.asarray(r) for r in resid]}
    state = compressor_state_from_jax(_numpy_state(rstate), device="cpu")
    rs, s = rcomp.plan_phase(rplan, 0), comp.plan_phase(plan, 0)
    assert s.selected == rs.selected == tuple(range(12))
    for step in range(2):
        grads = _tensors(plan, 10 + step)
        unflat = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(g) for g in grads])
        rout, rstate, rstats = rcomp.execute(rs, unflat, rstate, step=step)
        g_t = [torch.from_numpy(g) for g in grads]
        out, new_state, stats = comp.execute(s, g_t, state, step=step)
        assert stats.bytes_per_worker == rstats.bytes_per_worker
        assert all(np.array_equal(g.numpy(), x) for g, x in zip(g_t, grads))
        rout = jax.tree_util.tree_leaves(rout)
        for i, (a, b) in enumerate(zip(out, rout)):
            _assert_close(a.numpy(), b, f"step {step} leaf {i} synced")
        for key in ("q", "residual"):
            for i, (a, b) in enumerate(zip(new_state[key], rstate[key])):
                assert (a is None) == (b is None), (key, i)
                if a is None:
                    continue
                # a residual t - approx carries approx's error; on a leaf of
                # rank <= r (ln scales at REDUCED) it is all rounding noise
                scale = (float(np.max(np.abs(np.asarray(rout[i]))))
                         if key == "residual" else None)
                _assert_close(a.numpy(), b, f"step {step} {key} {i}", scale)
        if ef:
            assert not new_state["residual"][-1].any()     # the dense leaf
        state = new_state


@pytest.mark.parametrize("world", [1, 8])
def test_full_width_schedule_equals_reference(world):
    _, rplan, plan = _plans(reduced=False)
    r = r_get_compressor("powersgd", rank=2).plan_phase(rplan, 0, world=world)
    p = get_compressor("powersgd", rank=2).plan_phase(plan, 0, world=world)
    assert p.granularity == r.granularity == "leaf"
    assert p.num_phases == r.num_phases == 1
    assert len(p.calls) == len(r.calls) == 12
    assert p.bytes_per_worker == r.bytes_per_worker == FULL_WIDTH_BYTES
    assert p.dense_bytes == r.dense_bytes == 762_129_408
    assert p.volume_ratio == pytest.approx(r.volume_ratio, rel=1e-12)
    assert p.volume_ratio == pytest.approx(301.42, abs=0.005)
    assert [(c.target, c.op, c.wire_dtype, c.payload_bytes) for c in p.calls] == [
        (c.target, c.op, c.wire_dtype, c.payload_bytes) for c in r.calls]
    assert p.wire_bytes() == pytest.approx(r.wire_bytes())
    assert p.summary() == {k: v for k, v in r.summary().items() if k in p.summary()}


def test_guards_raise_as_in_the_reference():
    """A filter with a leaf wire, and ``sync="sharded"`` with ``powersgd``,
    both raise, in the port and in the reference."""
    with pytest.raises(ValueError, match="bucket granularity"):
        RSyncPipeline(wire=RLowRank(2), filter=RCoarseFilter(4))
    with pytest.raises(ValueError, match="bucket granularity"):
        SyncPipeline(wire=LowRank(2), filter=CoarseFilter(4))
    with pytest.raises(ValueError):
        r_get_compressor("powersgd", sync="sharded")
    with pytest.raises(ValueError, match="sync='sharded'"):
        get_compressor("powersgd", sync="sharded")
    assert not supports_sharded_sync(get_compressor("powersgd"))


def test_all_zero_leaf_gives_zeros_and_no_nan():
    """A zero gradient with a zero residual gives a zero P; its QR gives
    identity columns in both frameworks, so nothing turns NaN."""
    shapes, rplan, plan = _plans()
    q = RLowRank(2).init_state(shapes, rplan, use_ef=False)["q"]
    for leaf in (0, 6):                   # embed.table, ln1.scale (12, 128)
        z = np.zeros(plan.leaf_shapes[leaf], np.float32)
        approx, qn = LowRank(2).execute_leaf(torch.from_numpy(z),
                                             torch.from_numpy(np.array(q[leaf])), None)
        rapprox, rqn = RLowRank(2).execute_leaf(jnp.asarray(z), q[leaf], ())
        assert not approx.any() and not np.asarray(rapprox).any()
        assert torch.isfinite(qn).all() and np.isfinite(np.asarray(rqn)).all()
        np.testing.assert_array_equal(qn.numpy(), np.asarray(rqn))


def test_init_state_matches_the_reference_layout():
    """Q: ``(B, b, rank)`` normals for each leaf of two or more dimensions
    (``(1, b, r)`` for a 2-D leaf, including the (L, d) norm scales),
    ``None`` for the 1-D leaf; residuals zero with EF, ``None`` without.
    Drawn from ``seed`` in a CPU generator: equal across calls, different
    across seeds."""
    shapes, rplan, plan = _plans()
    params = [torch.zeros(s) for s in plan.leaf_shapes]
    for ef in (True, False):
        r = r_get_compressor("powersgd", ef=ef).init_state(shapes, rplan)
        st = get_compressor("powersgd", ef=ef).init_state(params, plan)
        for a, b in zip(st["q"], r["q"]):
            assert (a is None) == (b is None)
            if a is not None:
                assert tuple(a.shape) == tuple(b.shape) and a.dtype == torch.float32
        for a, b in zip(st["residual"], r["residual"]):
            assert (a is None) == (b is None) == (not ef)
            if a is not None:
                assert tuple(a.shape) == tuple(b.shape) and not a.any()
    a = get_compressor("powersgd", seed=3).init_state(params, plan)["q"]
    b = get_compressor("powersgd", seed=3).init_state(params, plan)["q"]
    c = get_compressor("powersgd", seed=4).init_state(params, plan)["q"]
    assert all(torch.equal(x, y) for x, y in zip(a[:-1], b[:-1]))
    assert not torch.equal(a[0], c[0])


def test_compressor_state_from_jax_keeps_nones_and_values():
    shapes, rplan, _ = _plans()
    r = r_get_compressor("powersgd").init_state(shapes, rplan)
    st = compressor_state_from_jax(_numpy_state(r), device="cpu")
    assert set(st) == {"q", "residual"}
    for key in st:
        for a, b in zip(st[key], r[key]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_wire_kernel_opt_in_raises_on_cpu_and_opt_out_runs():
    _, _, plan = _plans()
    grads = [torch.from_numpy(g) for g in _tensors(plan, 5)]
    for opts, fails in (({"use_wire_kernel": True}, True),
                        ({"use_wire_kernel": False}, False), ({}, False)):
        comp = get_compressor("powersgd", **opts)
        state = comp.init_state(grads, plan)
        if fails:
            with pytest.raises(ValueError, match="CUDA"):
                comp.execute(comp.plan_phase(plan, 0), grads, state)
        else:
            out, _, _ = comp.execute(comp.plan_phase(plan, 0), grads, state)
            assert all(torch.isfinite(x).all() for x in out)
