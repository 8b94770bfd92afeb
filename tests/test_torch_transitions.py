"""The port's re-plan boundary (``repro_torch.runtime.transitions`` and
``Trainer.replan``) against ``repro.runtime.transitions`` and the
reference's ``Trainer.replan``, on the REDUCED gpt2-paper.

* The four policies (``carry``, ``rescale`` when the interval shrinks and
  when it grows, ``flush``, and ``reinit`` on a structure change) on the
  same residuals from a numpy seed: the same effective policy, norms at
  rel 1e-6, and the same state (``carry`` keeps the tensors themselves, so
  the norm is preserved bit for bit; ``rescale`` bit for bit).
* ``residual_norm`` at rel 1e-6 on the three state shapes (a residual
  list, ``()``, PowerSGD's ``{"q", "residual"}`` with ``None`` holes).
* ``Trainer.replan``: the new plan and schedules equal the reference's,
  and 2 SGD steps at I=4, a re-plan to I=2 and 3 more steps match the
  reference's run at the trainer tests' bound (rtol 1e-4, atol 1e-6).
  Under the fused overlap the steps after a re-plan equal the post path's
  bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.core import get_compressor as r_get_compressor
from repro.data import DataConfig as RDataConfig
from repro.data import make_loader as r_make_loader
from repro.models import build_model as r_build_model
from repro.optim import sgd as r_sgd
from repro.runtime import transitions as rtrans
from repro.train.trainer import TrainConfig as RTrainConfig
from repro.train.trainer import Trainer as RTrainer

import repro_torch.configs as tconfigs
from repro_torch import optim
from repro_torch.core import build_plan, get_compressor
from repro_torch.data import DataConfig, make_loader
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.runtime import transitions
from repro_torch.train import TrainConfig, Trainer

torch.set_num_threads(2)

PLAN_KW = dict(bucket_bytes=1 << 14, max_buckets=32)
TC = dict(compressor="covap", interval=4, log_every=1, **PLAN_KW)
DATA = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)
LR = 1e-2


def _shapes():
    return jax.eval_shape(r_build_model(rconfigs.get_reduced("gpt2-paper")).init,
                          jax.random.PRNGKey(0))


def _setup(seed=0):
    """-> (reference params-like pytree, its treedef, the port's params in
    leaf order, residuals as numpy arrays in leaf order)."""
    shapes = _shapes()
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    rng = np.random.default_rng(seed)
    resid = [rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
    params = [torch.zeros(x.shape) for x in leaves]
    return shapes, treedef, params, resid


def _plans(interval):
    shapes = _shapes()
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="meta")
    return (r_build_plan(shapes, interval=interval, **PLAN_KW),
            build_plan(model.named_leaves(), interval=interval, **PLAN_KW))


def _carry(policy, old, new, comp="covap", to="covap", seed=0):
    shapes, treedef, params, resid = _setup(seed)
    rplan, plan = _plans(new)
    kw_new = {"interval": new} if to == "covap" else {}
    rcomp_old = r_get_compressor(comp, **({"interval": old} if comp == "covap" else {}))
    comp_old = get_compressor(comp, **({"interval": old} if comp == "covap" else {}))
    rstate = rcomp_old.init_state(shapes, _plans(old)[0])
    state = comp_old.init_state(params, _plans(old)[1])
    if isinstance(state, list):
        state = [torch.from_numpy(r) for r in resid]
        rstate = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(r) for r in resid])
    rout, rrep = rtrans.carry_comp_state(
        rstate, new_compressor=r_get_compressor(to, **kw_new), new_plan=rplan,
        params_like=shapes, step=7, old_interval=old, new_interval=new, policy=policy)
    out, rep = transitions.carry_comp_state(
        state, new_compressor=get_compressor(to, **kw_new), new_plan=plan,
        params_like=params, step=7, old_interval=old, new_interval=new, policy=policy)
    return state, out, rep, rout, rrep


def _assert_report(rep, rrep):
    assert (rep.step, rep.old_interval, rep.new_interval, rep.policy) == (
        rrep.step, rrep.old_interval, rrep.new_interval, rrep.policy)
    assert rep.norm_before == pytest.approx(rrep.norm_before, rel=1e-6)
    assert rep.norm_after == pytest.approx(rrep.norm_after, rel=1e-6, abs=1e-30)
    assert rep.norm_dropped == pytest.approx(rrep.norm_dropped, rel=1e-5, abs=1e-3)
    assert set(rep.summary()) == set(rrep.summary())


@pytest.mark.parametrize("policy,old,new,want", [
    ("carry", 4, 2, "carry"),
    ("carry", 4, 8, "carry"),
    ("rescale", 8, 2, "rescale"),
    ("rescale", 2, 8, "carry"),
    ("flush", 4, 2, "flush"),
])
def test_policies_match_reference(policy, old, new, want):
    state, out, rep, rout, rrep = _carry(policy, old, new)
    _assert_report(rep, rrep)
    assert rep.policy == want
    rleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(rout)]
    assert len(out) == len(rleaves)
    for a, b in zip(out, rleaves):
        np.testing.assert_array_equal(a.numpy(), b)
    if want == "carry":
        assert all(a is b for a, b in zip(out, state))
        assert rep.norm_after == rep.norm_before
    if want == "flush":
        assert rep.norm_after == 0.0 and rep.norm_before > 0


@pytest.mark.parametrize("comp,to,old,new", [
    ("covap", "covap", 4, 1),        # EF off at I = 1: the state is ()
    ("covap", "covap", 1, 4),        # and back on
    ("covap", "powersgd", 4, 4),     # another state family
])
def test_structure_change_reinits_like_the_reference(comp, to, old, new):
    _, out, rep, rout, rrep = _carry("carry", old, new, comp=comp, to=to)
    _assert_report(rep, rrep)
    assert rep.policy == "reinit"
    assert rep.norm_after == 0.0
    assert (out == ()) == (rout == ())


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown transition policy"):
        _carry("keep", 4, 2)


def test_residual_norm_matches_reference():
    shapes, treedef, params, resid = _setup(3)
    rtree = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(r) for r in resid])
    got = transitions.residual_norm([torch.from_numpy(r) for r in resid])
    assert got == pytest.approx(rtrans.residual_norm(rtree), rel=1e-6)
    assert transitions.residual_norm(()) == rtrans.residual_norm(()) == 0.0
    # PowerSGD: only the residual half counts; None holes are skipped
    q = [torch.ones(2, 3, 2) if i % 2 else None for i in range(len(resid))]
    half = [torch.from_numpy(r) if i % 3 else None for i, r in enumerate(resid)]
    rhalf = [jnp.asarray(r) if i % 3 else None for i, r in enumerate(resid)]
    rq = [jnp.ones((2, 3, 2)) if i % 2 else None for i in range(len(resid))]
    got = transitions.residual_norm({"q": q, "residual": half})
    want = rtrans.residual_norm({"q": rq, "residual": rhalf})
    assert got == pytest.approx(want, rel=1e-6)
    assert got == pytest.approx(transitions.residual_norm(
        [x for x in half if x is not None]), rel=0)


def _trainers(**kw):
    rtr = RTrainer(r_build_model(rconfigs.get_reduced("gpt2-paper")),
                   r_sgd(LR, momentum=0.9), RTrainConfig(**dict(TC, **kw)))
    rstate = rtr.init_state(jax.random.PRNGKey(0))
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, rstate["params"]),
                                          device="cpu"))
    tr = Trainer(model, optim.sgd(LR, momentum=0.9), TrainConfig(**dict(TC, **kw)))
    return rtr, rstate, tr, tr.init_state()


def _assert_plans_equal(plan, rplan):
    assert plan.num_buckets == rplan.num_buckets
    for pb, rb in zip(plan.buckets, rplan.buckets):
        assert (pb.index, pb.numel, pb.nbytes, pb.origin) == (
            rb.index, rb.numel, rb.nbytes, rb.origin)
        assert [tuple(vars(s).values()) for s in pb.segments] == [
            tuple(vars(s).values()) for s in rb.segments]


@pytest.mark.parametrize("new", [2, 8])
def test_replan_matches_reference(new):
    rtr, rstate, tr, state = _trainers()
    rit = iter(r_make_loader(RDataConfig(**DATA)))
    it = iter(make_loader(DataConfig(**DATA), device="cpu"))
    rstate = rtr.run(rstate, rit, steps=2, log=None)
    state = tr.run(state, it, steps=2, log=None)
    assert tr._steps
    rstate, rrep = rtr.replan(new, rstate, step=2)
    before = list(state["comp"])
    state, rep = tr.replan(new, state, step=2)
    _assert_report(rep, rrep)
    assert rep.policy == "carry" and rep.norm_after == rep.norm_before
    assert all(a is b for a, b in zip(state["comp"], before))
    assert tr.tc.interval == new and tr._steps == {} and tr.transitions == [rep]
    _assert_plans_equal(tr.plan, rtr.plan)
    assert tr.schedule_report() == rtr.schedule_report()
    rstate = rtr.run(rstate, rit, steps=3, log=None)
    state = tr.run(state, it, steps=3, log=None)
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in rtr.history], rtol=1e-5)
    flat = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_leaves_with_path(rstate)}
    for path, p, r in zip(tr.leaf_names, state["params"], state["comp"]):
        key = "".join(f"['{k}']" for k in path.split("."))
        np.testing.assert_allclose(p.detach().numpy(), flat["['params']" + key],
                                   rtol=1e-4, atol=1e-6, err_msg=path)
        np.testing.assert_allclose(r.numpy(), flat["['comp']" + key],
                                   rtol=1e-4, atol=1e-6, err_msg=path)


def test_replan_without_state_and_default_old_interval():
    _, _, tr, state = _trainers()
    assert tr.replan(8) == (None, None)
    assert tr.tc.interval == 8 and tr.compressor.num_phases() == 8
    state, rep = tr.replan(2, state, policy="rescale")
    assert (rep.old_interval, rep.new_interval, rep.policy) == (8, 2, "rescale")


@pytest.mark.parametrize("options", [{}, {"arena": True}, {"sync": "sharded"}])
def test_fused_steps_after_replan_equal_post(options):
    """Each fused step creates its hooks from its phase's schedule, so the
    steps after a re-plan run the new plan's buckets; they equal the post
    path's steps bit for bit."""
    loader = make_loader(DataConfig(**DATA), device="cpu")
    runs = {}
    for overlap in ("post", "fused"):
        _, _, tr, state = _trainers(overlap=overlap, **options)
        state = tr.run(state, iter([loader.make(s) for s in range(2)]), steps=2,
                       log=None)
        state, _ = tr.replan(2, state, step=2)
        assert tr.plan.num_buckets > 1
        state = tr.run(state, iter([loader.make(s) for s in range(2, 5)]), steps=3,
                       log=None)
        if overlap == "fused":
            # EF on: every bucket of the new plan has its hook
            assert sorted(tr.last_step_fn.fired) == list(range(tr.plan.num_buckets))
        runs[overlap] = state["params"] + state["comp"]
    assert all(torch.equal(a, b) for a, b in zip(runs["fused"], runs["post"]))
