"""The port's fused overlap (``core.overlap``): each bucket's hook starts its
collective inside the backward pass, in ``ReadyOrder``, and the step equals
the post step.

* ``build_ready_order`` and each phase's ``ready_ranks`` against the
  reference's on the same plans: REDUCED gpt2-paper with small buckets,
  full-width gpt2-paper from ``meta`` tensors, and the reference's toy
  trees (``tests/test_overlap.py``).
* ``overlap="fused"`` against ``overlap="post"`` in the port, one worker,
  by ``torch.equal``: one step's synced gradients and residuals in every
  phase, and the params, momenta and residuals after a full phase cycle + 1
  steps, for covap, none and fp16 with the arena off and on, under sharded
  sync, and with ``remat=True`` (``torch.utils.checkpoint`` under the
  hooks).  Signed zeros may differ: on the post path ``AccumulateGrad``
  sums the per-row gradients of a stacked leaf, which turns a ``-0.0`` row
  into ``+0.0``, where the fused path hands the row on as it is.
  ``torch.equal`` counts ``-0.0 == +0.0``; a bit view would not.
* The fused run against the reference's ``overlap="post"`` run at the
  tolerance of ``tests/test_torch_trainer.py`` (never against the
  reference's fused tests, three of which fail on this tree).
* The hooks fire in ``ReadyOrder.order()`` up to ties of equal
  ``bucket_layer``; every collective starts inside ``backward()`` with
  ``async_op=True`` and every wait comes after it (a one-rank gloo group);
  flat and leaf pipelines raise ``ValueError``; a plan that leaves part of
  a leaf uncovered raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.core import build_ready_order as r_build_ready_order
from repro.core import get_compressor as r_get_compressor
from repro.data import DataConfig as RDataConfig
from repro.data import make_loader as r_make_loader
from repro.models import build_model as r_build_model
from repro.optim import sgd as r_sgd
from repro.train.trainer import TrainConfig as RTrainConfig
from repro.train.trainer import Trainer as RTrainer

import repro_torch.configs as tconfigs
from repro_torch.core import build_plan, build_ready_order, get_compressor
from repro_torch.core.overlap import (
    _assert_full_coverage,
    overlapped_loss_and_grads,
    supports_fused_overlap,
)
from repro_torch.data import DataConfig, make_loader
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.optim import sgd
from repro_torch.train import TrainConfig, Trainer, loss_and_grads

torch.set_num_threads(2)

STEPS = 5                      # a full phase cycle (I = 4) + 1
SMALL = dict(bucket_bytes=1 << 13, max_buckets=64)
DATA = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)
LR = 1e-2


# ---------------------------------------------------------------------------
# ReadyOrder and ready_ranks against the reference
# ---------------------------------------------------------------------------

def _gpt2_plans(reduced, **kw):
    get = "get_reduced" if reduced else "get_config"
    shapes = jax.eval_shape(r_build_model(getattr(rconfigs, get)("gpt2-paper")).init,
                            jax.random.PRNGKey(0))
    port = build_model(getattr(tconfigs, get)("gpt2-paper"), device="meta")
    return r_build_plan(shapes, **kw), build_plan(port.named_leaves(), **kw)


def _toy_plans(leaves, **kw):
    ref = r_build_plan({k: jnp.zeros(s) for k, s in leaves.items()}, **kw)
    port = build_plan([(k, torch.zeros(s)) for k, s in sorted(leaves.items())], **kw)
    return ref, port


PLANS = {
    "reduced-small": lambda: _gpt2_plans(True, interval=4, **SMALL),
    "full-width": lambda: _gpt2_plans(False),
    "toy-3-leaves": lambda: _toy_plans({"a": (8, 4), "b": (8, 4), "c": (4,)},
                                       bucket_bytes=64, max_buckets=16, interval=2),
    "toy-w-b": lambda: _toy_plans({"w": (64, 16), "b": (16,)}, bucket_bytes=512,
                                  max_buckets=8, interval=4),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_ready_order_and_ready_ranks_equal_reference(name):
    ref, port = PLANS[name]()
    assert port.num_buckets == ref.num_buckets
    want, got = r_build_ready_order(ref), build_ready_order(port)
    assert got.bucket_layer == want.bucket_layer
    assert got.ranks == want.ranks
    assert got.num_layers == want.num_layers
    assert got.order == want.order
    assert sorted(got.order) == list(range(port.num_buckets))
    for sync in ("allreduce", "sharded"):
        rcomp = r_get_compressor("covap", interval=4, sync=sync)
        comp = get_compressor("covap", interval=4, sync=sync)
        for phase in range(4):
            rs = rcomp.plan_phase(ref, phase, world=8)
            s = comp.plan_phase(port, phase, world=8)
            assert s.selected == rs.selected
            assert s.ready_ranks == rs.ready_ranks
            assert s.issue_order() == rs.issue_order()


def test_leaf_path_schedule_has_no_ready_ranks():
    _, port = _gpt2_plans(True, **SMALL)
    s = get_compressor("powersgd").plan_phase(port, 0)
    assert s.ready_ranks == () and s.issue_order() == tuple(range(len(s.calls)))


# ---------------------------------------------------------------------------
# fused == post in the port
# ---------------------------------------------------------------------------

FORMS = {
    "covap": {},
    "covap-arena": {"arena": True},
    "none": {"compressor": "none"},
    "none-arena": {"compressor": "none", "arena": True},
    "fp16": {"compressor": "fp16"},
    "fp16-arena": {"compressor": "fp16", "arena": True},
    "covap-sharded": {"sync": "sharded"},
}


def _trainer(overlap, cfg=None, **kw):
    cfg = cfg or tconfigs.get_reduced("gpt2-paper")
    model = build_model(cfg, device="cpu", seed=0)
    tc = TrainConfig(overlap=overlap, steps=STEPS, log_every=1, **SMALL, **kw)
    return Trainer(model, sgd(LR, momentum=0.9), tc)


def _loader():
    return make_loader(DataConfig(**DATA), device="cpu")


def _leaves(state):
    comp = state["comp"]
    return (list(state["params"]) + list(state["opt"]["mu"])
            + (list(comp) if isinstance(comp, list) else []))


def _assert_equal(got, want, what):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), (what, i, float((a - b).abs().max()))


def test_small_plan_covers_every_stage():
    tr = _trainer("fused")
    plan = tr.plan
    stages = {p.split(".")[0] if not p.startswith("stack.") else p.split(".")[1]
              for b in plan.buckets for s in b.segments
              for p in [plan.leaf_paths[s.leaf_idx]]}
    assert plan.num_buckets >= 8
    assert {"embed", "blocks", "final_norm", "head"} <= stages
    rows = {s.row_lo for b in plan.buckets for s in b.segments
            if plan.leaf_paths[s.leaf_idx].startswith("stack.blocks.")}
    assert len(rows) >= 2


@pytest.mark.parametrize("form", sorted(FORMS))
def test_fused_step_equals_post_execute(form):
    """One step in each phase from the same state and batch: the fused
    core's synced gradients and residuals against ``loss_and_grads`` +
    ``execute``, by ``torch.equal``."""
    tr = _trainer("fused", **FORMS[form])
    state = tr.init_state()
    batch = _loader().make(0)
    comp = tr.compressor
    # a non-zero residual, so that EF's compensation is exercised
    if isinstance(state["comp"], list):
        gen = torch.Generator().manual_seed(1)
        state["comp"] = [1e-3 * torch.randn(r.shape, generator=gen) for r in state["comp"]]
    for phase in range(tr.num_phases):
        sched = comp.plan_phase(tr.plan, phase)
        grads, metrics = loss_and_grads(tr.model, state["params"], batch)
        want, want_state, _ = comp.execute(sched, grads, state["comp"], step=phase)
        loss, fmetrics, got, got_state, sync, hooks = overlapped_loss_and_grads(
            tr.model, comp, sched, state["params"], state["comp"], batch, phase)
        assert torch.equal(loss, metrics["total_loss"])
        assert all(p.grad is None for p in state["params"])
        _assert_equal(got, want, f"{form} phase {phase} synced")
        if isinstance(want_state, list):
            _assert_equal(got_state, want_state, f"{form} phase {phase} residual")
        if tr.num_phases > 1:          # COVAP leaves buckets unselected
            assert set(range(tr.plan.num_buckets)) - set(sched.selected)


@pytest.mark.parametrize("form", sorted(FORMS) + ["covap-remat", "covap-bf16"])
def test_fused_trainer_equals_post_after_full_cycle(form):
    """``covap-bf16`` computes in bfloat16, as full width does: the leaves
    that several buckets split (the embedding table, the head) are joined
    from pieces cast to bfloat16."""
    cfg = tconfigs.get_reduced("gpt2-paper")
    kw = dict(FORMS.get(form, {}))
    if form == "covap-remat":
        cfg = cfg.with_(remat=True)
    if form == "covap-bf16":
        cfg = cfg.with_(compute_dtype="bfloat16")
    runs = {}
    for overlap in ("post", "fused"):
        tr = _trainer(overlap, cfg, **kw)
        state = tr.run(tr.init_state(), _loader(), log=None)
        runs[overlap] = (tr, state)
    (tp, sp), (tf, sf) = runs["post"], runs["fused"]
    assert sf["step"] == STEPS
    assert [h["loss"] for h in tf.history] == [h["loss"] for h in tp.history]
    assert [h["grad_norm"] for h in tf.history] == [h["grad_norm"] for h in tp.history]
    _assert_equal(_leaves(sf), _leaves(sp), form)
    assert tf.last_step_fn.fired and not tp.last_step_fn.fired


def test_fused_hooks_fire_in_ready_order():
    tr = _trainer("fused")
    tr.run(tr.init_state(), _loader(), steps=1, log=None)
    ready = build_ready_order(tr.plan)
    fired = tr.last_step_fn.fired
    assert sorted(fired) == list(range(tr.plan.num_buckets))
    layers = [ready.bucket_layer[b] for b in fired]
    assert layers == sorted(layers, reverse=True)
    # equal to the order itself up to ties of equal bucket_layer
    key = [sorted(b for b in fired if ready.bucket_layer[b] == d)
           for d in sorted(set(layers), reverse=True)]
    want = [sorted(b for b in ready.order if ready.bucket_layer[b] == d)
            for d in sorted(set(layers), reverse=True)]
    assert key == want


def test_fused_matches_reference_post(tmp_path):
    """The fused run (arena off and on) against the reference's post run,
    5 SGD steps from the same parameters: losses at rtol 1e-5, params and
    residuals at rtol 1e-4, atol 1e-6 (``tests/test_torch_trainer.py``)."""
    tc = dict(compressor="covap", interval=4, log_every=1, steps=STEPS, **SMALL)
    rtr = RTrainer(r_build_model(rconfigs.get_reduced("gpt2-paper")),
                   r_sgd(LR, momentum=0.9), RTrainConfig(**tc))
    rstate = rtr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, rstate["params"])
    rstate = rtr.run(rstate, iter(r_make_loader(RDataConfig(**DATA))), log=None)
    rparams = [np.asarray(x) for x in jax.tree_util.tree_leaves(rstate["params"])]
    rresid = [np.asarray(x) for x in jax.tree_util.tree_leaves(rstate["comp"])]
    for arena in (False, True):
        model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu")
        model.load_state_dict(params_from_jax(init, device="cpu"))
        tr = Trainer(model, sgd(LR, momentum=0.9),
                     TrainConfig(overlap="fused", arena=arena, **tc))
        state = tr.run(tr.init_state(), _loader(), log=None)
        np.testing.assert_allclose([h["loss"] for h in tr.history],
                                   [h["loss"] for h in rtr.history], rtol=1e-5)
        for i, (p, r) in enumerate(zip(state["params"], state["comp"])):
            np.testing.assert_allclose(p.detach().numpy(), rparams[i], rtol=1e-4,
                                       atol=1e-6, err_msg=f"param {i}")
            np.testing.assert_allclose(r.numpy(), rresid[i], rtol=1e-4, atol=1e-6,
                                       err_msg=f"residual {i}")


@pytest.fixture
def one_rank_gloo(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("form", ["covap", "covap-arena", "covap-sharded"])
def test_fused_collectives_start_inside_backward_and_wait_after(one_rank_gloo, form):
    """In a one-rank gloo group: every bucket's start (EF on: every bucket)
    comes before ``backward()`` returns, and every wait after it, in the
    order of the starts."""
    tr = _trainer("fused", **FORMS[form])
    comp = tr.compressor
    state = tr.init_state()
    sched = comp.plan_phase(tr.plan, 0, world=1)
    *_, sync, hooks = overlapped_loss_and_grads(
        tr.model, comp, sched, state["params"], state["comp"], _loader().make(0), 0,
        group=one_rank_gloo)
    ev = sync.events
    end = ev.index(("backward_done", -1))
    assert all(k == "start" for k, _ in ev[:end])
    assert all(k == "wait" for k, _ in ev[end + 1:])
    starts = [b for _, b in ev[:end]]
    assert sorted(starts) == list(range(tr.plan.num_buckets))
    assert [b for _, b in ev[end + 1:]] == starts == hooks.fired


def test_fused_start_leaves_async_work_pending(one_rank_gloo):
    """The hook's start returns with its selected bucket's collective in
    flight (an ``async_op=True`` work, not waited for)."""
    tr = _trainer("fused")
    comp = tr.compressor
    state = tr.init_state()
    sched = comp.plan_phase(tr.plan, 0, world=1)
    from repro_torch.core.overlap import install_hooks
    from repro_torch.core.stages import StepSync

    sync = StepSync(comp, sched, state["params"], state["comp"], step=0,
                    group=one_rank_gloo)
    tree, hooks = install_hooks(sync, state["params"])
    total, _ = tr.model.loss_fn(_loader().make(0), params=tree)
    total.backward()
    assert sorted(sync.pending) == sorted(hooks.fired)
    for b, pending in sync.pending.items():
        if b in sched.selected:
            assert pending.works and all(w is not None for w in pending.works)
        else:
            assert all(w is None for w in pending.works)
    for b in list(sync.started):
        sync.finish(b)
    synced, _ = sync.close()
    assert all(torch.isfinite(x).all() for x in synced)


@pytest.mark.parametrize("compressor", ["fp8wire", "efsignsgd", "powersgd"])
def test_fused_refuses_flat_and_leaf_pipelines(compressor):
    comp = get_compressor(compressor)
    assert not supports_fused_overlap(comp)
    with pytest.raises(ValueError):
        _trainer("fused", compressor=compressor)
    tr = _trainer("post", compressor=compressor)
    state = tr.init_state()
    with pytest.raises(ValueError):
        overlapped_loss_and_grads(tr.model, comp, comp.plan_phase(tr.plan, 0),
                                  state["params"], state["comp"], _loader().make(0), 0)


def test_uncovered_plan_refuses_hooks():
    tr = _trainer("fused")
    plan = tr.plan
    _assert_full_coverage(plan)
    short = dataclasses.replace(plan, buckets=plan.buckets[:-1])
    with pytest.raises(ValueError, match="cannot install gradient hooks"):
        _assert_full_coverage(short)
    b = plan.buckets[0]
    seg = b.segments[0]
    cut = dataclasses.replace(b, segments=(dataclasses.replace(seg, row_hi=seg.row_hi - 1),)
                              + b.segments[1:])
    with pytest.raises(ValueError, match="cannot install gradient hooks"):
        _assert_full_coverage(dataclasses.replace(plan, buckets=(cut,) + plan.buckets[1:]))
