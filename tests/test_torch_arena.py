"""The port's zero-copy arena (``core/arena.py``) and the arena form of
``SyncPipeline.execute`` against the reference, on the REDUCED gpt2-paper
(f32 leaves), one worker.

* ``build_layout`` gives the reference's offsets, extents and padding.
* ``pack_leaves`` / ``unpack_bucket`` / ``gather_leaves`` round-trip.
* Arena execute equals the port's per-segment execute BITWISE (covap,
  covap with a bf16 wire, none, fp16), and both are held against the
  reference's ``execute`` with ``use_arena=False``.
* ``Trainer.run`` with ``arena=True`` against the reference trainer's
  ``arena=False`` run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.core import arena as rarena
from repro.core import build_plan as r_build_plan
from repro.core import get_compressor as r_get_compressor
from repro.data import DataConfig as RDataConfig
from repro.data import make_loader as r_make_loader
from repro.models import build_model as r_build_model
from repro.optim import sgd as r_sgd
from repro.train.trainer import TrainConfig as RTrainConfig
from repro.train.trainer import Trainer as RTrainer

import repro_torch.configs as tconfigs
from repro_torch.core import arena, build_plan, get_compressor
from repro_torch.core.bucketing import Bucket, BucketPlan, Segment
from repro_torch.data import DataConfig, make_loader
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.optim import sgd
from repro_torch.train import TrainConfig, Trainer

torch.set_num_threads(2)

PLAN_KW = dict(bucket_bytes=1 << 14, max_buckets=32)
CASES = [
    ("covap", {"interval": 4}),
    ("covap", {"interval": 4, "wire_dtype": "bfloat16"}),
    ("none", {}),
    ("fp16", {}),
]
CASE_IDS = ["covap", "covap-bf16", "none", "fp16"]


def _plans(interval=4):
    rcfg = rconfigs.get_reduced("gpt2-paper")
    shapes = jax.eval_shape(r_build_model(rcfg).init, jax.random.PRNGKey(0))
    rplan = r_build_plan(shapes, interval=interval, **PLAN_KW)
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="meta")
    plan = build_plan(model.named_leaves(), interval=interval, **PLAN_KW)
    return rplan, plan, jax.tree_util.tree_structure(shapes)


def _tensors(plan, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in plan.leaf_shapes]


def _layout_fields(layout):
    return (layout.buckets, layout.plane_dtypes, layout.plane_sizes,
            layout.bucket_plane, layout.bucket_offsets, layout.bucket_numels,
            layout.seg_offsets, layout.align)


@pytest.mark.parametrize("world", [1, 2, 8])
@pytest.mark.parametrize("interval", [1, 4, 7])
def test_build_layout_equals_reference(interval, world):
    rplan, plan, _ = _plans(interval)
    assert plan.num_buckets == rplan.num_buckets
    selections = [None] + [
        get_compressor("covap", interval=interval).plan_phase(plan, p).selected
        for p in range(max(interval, 1))
    ]
    for sel in selections:
        for wd, rwd in ((None, None), (torch.bfloat16, jnp.bfloat16)):
            got = arena.build_layout(plan, sel, wire_dtype=wd, align=world)
            want = rarena.build_layout(rplan, sel, wire_dtype=rwd, align=world)
            assert _layout_fields(got) == _layout_fields(want)
            assert got.nbytes() == want.nbytes()
            for b in got.buckets:
                assert got.slot(b) == want.slot(b)
                assert arena.aligned_numel(plan.buckets[b].numel, world) == \
                    got.slot(b)[2]


def test_pack_unpack_and_gather_round_trip():
    _, plan, _ = _plans()
    leaves = [torch.from_numpy(x) for x in _tensors(plan, 0)]
    layout = arena.build_layout(plan, align=8)
    planes = arena.pack_leaves(layout, leaves)
    pieces = {}
    for b in layout.buckets:
        _, off, extent = layout.slot(b)
        real = plan.buckets[b].numel
        # the aligned tail of every slot is zero
        assert torch.count_nonzero(layout.bucket_view(planes, b)[real:]) == 0
        pieces[b] = layout.unpack_bucket(b, layout.bucket_view(planes, b))
        for si, (seg, piece) in enumerate(zip(plan.buckets[b].segments, pieces[b])):
            want = arena.bk._slice_segment(leaves[seg.leaf_idx], seg)
            assert torch.equal(piece, want)
            assert torch.equal(layout.segment_view(planes, b, si),
                               want.reshape(-1))
    back = arena.gather_leaves(plan, lambda b, si, seg: pieces[b][si], leaves)
    assert all(torch.equal(x, y) for x, y in zip(back, leaves))
    # pieces of None are zeros; ``out`` is written in place
    out = [torch.full_like(x, 7.0) for x in leaves]
    arena.gather_leaves(
        plan, lambda b, si, seg: pieces[b][si] if b % 2 else None, leaves, out=out,
    )
    for b, bucket in enumerate(plan.buckets):
        for si, seg in enumerate(bucket.segments):
            got = arena.bk._slice_segment(out[seg.leaf_idx], seg)
            assert torch.equal(got, pieces[b][si] if b % 2 else torch.zeros_like(got))


def test_gather_leaves_with_a_non_contiguous_cover():
    """A leaf whose segments do not tile it in bucket order (``leaf_cover``
    gives ``None``) and a sub-axis split still round-trip; the reference's
    ``leaf_cover`` agrees on which leaves tile."""
    shapes = ((6, 4), (1, 8, 6))
    buckets = (
        Bucket(0, (Segment(0, 3, 6),), 12, 48, 0),
        Bucket(1, (Segment(0, 0, 3), Segment(1, 0, 1, 1, 0, 3)), 30, 120, 1),
        Bucket(2, (Segment(1, 0, 1, 1, 3, 8),), 30, 120, 1),
    )
    plan = BucketPlan(buckets, shapes, (torch.float32,) * 2, ("a", "b"),
                      1 << 10, 4)
    assert [c is None for c in arena.leaf_cover(plan)] == [True, False]
    rplan = rarena.BucketPlan(
        tuple(rarena.bk.Bucket(b.index, tuple(rarena.bk.Segment(*vars(s).values())
                                               for s in b.segments),
                               b.numel, b.nbytes, b.origin) for b in buckets),
        shapes, (np.dtype(np.float32),) * 2, ("a", "b"), None, 1 << 10, 4,
    )
    assert [c is None for c in rarena.leaf_cover(rplan)] == [True, False]
    leaves = [torch.from_numpy(x) for x in _tensors(plan, 1)]
    layout = arena.build_layout(plan, align=4)
    planes = arena.pack_leaves(layout, leaves)
    back = arena.gather_leaves(
        plan, lambda b, si, seg: layout.unpack_bucket(b, layout.bucket_view(planes, b))[si],
        leaves,
    )
    assert all(torch.equal(x, y) for x, y in zip(back, leaves))


def _execute_port(name, kw, plan, grads, resid, step, **opts):
    comp = get_compressor(name, **kw, **opts)
    s = comp.plan_phase(plan, step % comp.num_phases())
    state = [torch.from_numpy(r) for r in resid] if comp.ef is not None else ()
    out, new_state, stats = comp.execute(
        s, [torch.from_numpy(g) for g in grads], state, step=step)
    return comp, s, out, new_state, stats


@pytest.mark.parametrize("step", [0, 1, 2, 3, 405])
@pytest.mark.parametrize("name,kw", CASES, ids=CASE_IDS)
def test_arena_equals_per_segment_bitwise(name, kw, step):
    """Arena on == arena off, and sharded sync on one worker (no group: the
    reduce-scatter is the identity) == allreduce, bit for bit."""
    _, plan, _ = _plans()
    grads, resid = _tensors(plan, 2), _tensors(plan, 3)
    _, _, base, base_state, _ = _execute_port(name, kw, plan, grads, resid, step)
    for opts in ({"use_arena": True}, {"sync": "sharded"},
                 {"use_arena": True, "sync": "sharded"}):
        _, _, out, state, _ = _execute_port(name, kw, plan, grads, resid, step, **opts)
        assert all(torch.equal(a, b) for a, b in zip(out, base)), opts
        if base_state == ():
            assert state == ()
        else:
            assert all(torch.equal(a, b) for a, b in zip(state, base_state)), opts


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("name,kw", CASES, ids=CASE_IDS)
def test_arena_execute_matches_reference(name, kw, step):
    """The port's arena execute against the reference's per-segment
    ``execute`` (``use_arena=False``, eager on the CPU) at the EF tolerance
    of ``test_torch_stages.py``, rtol 1e-6 and atol 1e-6 * max|c r| (zeros exact); a bf16
    wire is compared after its cast back to f32."""
    rplan, plan, treedef = _plans()
    grads, resid = _tensors(plan, 4), _tensors(plan, 5)
    comp, s, out, state, stats = _execute_port(
        name, kw, plan, grads, resid, step, use_arena=True)
    rcomp = r_get_compressor(name, **kw)
    rs = rcomp.plan_phase(rplan, step % rcomp.num_phases())
    assert s.selected == rs.selected
    unflat = lambda xs: jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in xs])
    rout, rstate, rstats = rcomp.execute(
        rs, unflat(grads), unflat(resid) if rcomp.ef is not None else (), step=step)
    assert stats.bytes_per_worker == rstats.bytes_per_worker
    c = comp.ef_coefficient(step) or 0.0
    for a, b, r in zip(out, jax.tree_util.tree_leaves(rout), resid):
        _assert_ef_close(a.numpy(), np.asarray(b, np.float32), r, c)
    if comp.ef is not None:
        for a, b, r in zip(state, jax.tree_util.tree_leaves(rstate), resid):
            _assert_ef_close(a.numpy(), np.asarray(b), r, c)


def _assert_ef_close(got, want, r, c):
    atol = 1e-6 * float(np.max(np.abs(c * r)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
    np.testing.assert_array_equal(got == 0, want == 0)


def test_pack_kernel_opt_in_raises_on_cpu_and_opt_out_runs():
    _, plan, _ = _plans()
    grads, resid = _tensors(plan, 6), _tensors(plan, 7)
    with pytest.raises(ValueError, match="CUDA"):
        _execute_port("covap", {"interval": 4}, plan, grads, resid, 0,
                      use_arena=True, use_pack_kernel=True)
    _, _, a, ra, _ = _execute_port("covap", {"interval": 4}, plan, grads, resid, 1,
                                   use_arena=True, use_pack_kernel=False)
    _, _, b, rb, _ = _execute_port("covap", {"interval": 4}, plan, grads, resid, 1,
                                   use_arena=True)
    assert all(torch.equal(x, y) for x, y in zip(a + ra, b + rb))


def test_trainer_arena_matches_reference():
    """``Trainer.run`` with ``arena=True`` against the reference trainer's
    default ``arena=False`` run over a COVAP cycle plus one step, at the
    SGD tolerances of ``test_torch_trainer.py`` (losses rtol 1e-5; params and residuals rtol
    1e-4, atol 1e-6)."""
    steps, lr = 5, 1e-2
    tc = dict(compressor="covap", interval=4, log_every=1, steps=steps, **PLAN_KW)
    data = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)
    rtr = RTrainer(r_build_model(rconfigs.get_reduced("gpt2-paper")),
                   r_sgd(lr, momentum=0.9), RTrainConfig(**tc))
    rstate = rtr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, rstate["params"])
    rstate = rtr.run(rstate, iter(r_make_loader(RDataConfig(**data))), log=None)

    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu")
    model.load_state_dict(params_from_jax(init, device="cpu"))
    tr = Trainer(model, sgd(lr, momentum=0.9), TrainConfig(arena=True, **tc))
    assert tr.compressor._arena_on()
    state = tr.run(tr.init_state(), make_loader(DataConfig(**data), device="cpu"),
                   log=None)
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in rtr.history], rtol=1e-5)
    rparams = jax.tree_util.tree_leaves(rstate["params"])
    rresid = jax.tree_util.tree_leaves(rstate["comp"])
    for p, rp, r, rr in zip(state["params"], rparams, state["comp"], rresid):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(rp),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(r.numpy(), np.asarray(rr), rtol=1e-4, atol=1e-6)
