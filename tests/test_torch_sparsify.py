"""The sparsifying baselines on the port's flat-bucket path (``topk``,
``dgc``, ``randomk``, ``oktopk``) against ``repro.core``'s.

* Plans: every call (target, op, wire dtype, payload and index bytes), the
  selected buckets (OkTopK repeats each bucket for its two calls) and the
  ready ranks equal the reference's exactly at W = 1, 2 and 8, at full width
  and on REDUCED with small buckets; so do the bytes per worker and the
  ring-amplified wire bytes (``all_to_all`` moves ``(W-1)/W`` of its
  buffer).
* ``execute`` against the reference's (eager, one worker) on the same
  gradients and residuals from a numpy seed: TopK, OkTopK and DGC with a
  clip that does not bind bit for bit.  With a binding clip DGC scales by
  ``clip / ||t||``, and the two frameworks sum the norm's squares in
  another order, so its values are held at rtol 1e-6.  The data is normal
  noise, so ``|t|`` has no ties at the k-th value (where ``torch.topk`` and
  ``lax.top_k`` may keep other indices).  Random-k is fed the reference's
  own indices (``jax.random`` streams cannot be reproduced in torch,
  through the ``RandomK.indices`` seam) and then equals it bit for bit; the
  port's own draw is held to determinism for a fixed key and to a uniform
  distribution.
* The arena form equals the per-bucket form bit for bit.
* OkTopK in a one-rank gloo group equals OkTopK without a group and TopK,
  bit for bit; at W = 2 and 3 on gloo each stage equals a numpy oracle of
  its exchange (at W = 3 the capacity windows overflow and drop entries).
* Trainer runs on REDUCED (5 SGD steps) against the reference's at allclose.
* The fused overlap and sharded sync refuse all four.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.core import get_compressor as r_get_compressor
from repro.data import DataConfig as RDataConfig
from repro.data import make_loader as r_make_loader
from repro.models import build_model as r_build_model
from repro.optim import sgd as r_sgd
from repro.train.trainer import TrainConfig as RTrainConfig
from repro.train.trainer import Trainer as RTrainer

import repro_torch.configs as tconfigs
from repro_torch.core import build_plan, get_compressor, stages
from repro_torch.core.overlap import supports_fused_overlap, supports_sharded_sync
from repro_torch.core.stages import BucketKey, OkTopKRoute, RandomK, TopK
from repro_torch.data import DataConfig, make_loader
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.optim import sgd
from repro_torch.train import TrainConfig, Trainer

from _torch_dist_worker import sparse_worker

torch.set_num_threads(2)

NAMES = ["topk", "dgc", "randomk", "oktopk"]
PLAN_KW = dict(bucket_bytes=1 << 14, max_buckets=32, interval=4)
TC = dict(bucket_bytes=1 << 14, max_buckets=32, log_every=1, steps=5)
DATA = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)
LR = 1e-2
CASES = [("topk", {}), ("topk", {"ef": False}), ("topk", {"ratio": 0.05}),
         ("dgc", {"clip_norm": 1e6}), ("oktopk", {}), ("oktopk", {"ratio": 0.05}),
         ("randomk", {}), ("randomk", {"ef": False})]
CASE_IDS = ["topk", "topk-no-ef", "topk-5%", "dgc-clip-unbound", "oktopk",
            "oktopk-5%", "randomk", "randomk-no-ef"]


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


def _reference_indices(self, key, n, device):
    """The reference's Random-k draw for ``key``'s (seed, step, bucket):
    ``randint(fold_in(fold_in(PRNGKey(seed), step), bucket), (k,), 0, n)``."""
    k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(key.seed),
                                              jnp.asarray(key.step, jnp.int32)),
                           key.bucket)
    m = max(1, int(math.ceil(n * self.ratio)))
    idx = np.asarray(jax.random.randint(k, (m,), 0, n)).astype(np.int64)
    return torch.from_numpy(idx).to(device)


@pytest.fixture
def reference_draw(monkeypatch):
    monkeypatch.setattr(RandomK, "indices", _reference_indices)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full-width", "reduced"])
@pytest.mark.parametrize("world", [1, 2, 8])
@pytest.mark.parametrize("name", NAMES)
def test_plan_bytes_equal_reference(name, world, reduced):
    kw = PLAN_KW if reduced else {}
    rplan, plan, _ = _plans(reduced, **kw)
    r = r_get_compressor(name).plan_phase(rplan, 0, world=world)
    p = get_compressor(name).plan_phase(plan, 0, world=world)
    assert p.num_phases == r.num_phases == 1
    assert p.selected == r.selected and p.ready_ranks == r.ready_ranks
    assert len(p.calls) == (2 if name == "oktopk" else 1) * plan.num_buckets
    assert [(c.target, c.op, c.wire_dtype, c.payload_bytes, c.index_bytes)
            for c in p.calls] == [
        (c.target, c.op, c.wire_dtype, c.payload_bytes, c.index_bytes)
        for c in r.calls]
    assert p.bytes_per_worker == r.bytes_per_worker
    assert p.wire_bytes() == pytest.approx(r.wire_bytes(), rel=1e-12)
    assert p.summary() == {k: v for k, v in r.summary().items() if k in p.summary()}


def test_full_width_plan_bytes():
    """The bytes a worker sends a step at full width (W = 1 for the
    sparsifiers whose plan does not depend on W; OkTopK at W = 8)."""
    _, plan, _ = _plans(reduced=False)
    got = {name: get_compressor(name).plan_phase(plan, 0, world=1).bytes_per_worker
           for name in ("topk", "dgc", "randomk")}
    got["oktopk@8"] = get_compressor("oktopk").plan_phase(plan, 0, world=8).bytes_per_worker
    assert got == {"topk": 15_242_680, "dgc": 1_524_400, "randomk": 7_621_340,
                   "oktopk@8": 47_640_760}


# ---------------------------------------------------------------------------
# execute, one worker
# ---------------------------------------------------------------------------

def _execute_port(name, kw, plan, grads, resid, step, **opts):
    comp = get_compressor(name, **kw, **opts)
    s = comp.plan_phase(plan, 0)
    state = [torch.from_numpy(r) for r in resid] if comp.ef is not None else ()
    out, new_state, _ = comp.execute(
        s, [torch.from_numpy(g) for g in grads], state, step=step)
    return comp, s, out, new_state


def _execute_reference(name, kw, rplan, treedef, grads, resid, step):
    rcomp = r_get_compressor(name, **kw)
    rs = rcomp.plan_phase(rplan, 0)
    unflat = lambda xs: jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in xs])
    rout, rstate, _ = rcomp.execute(
        rs, unflat(grads), unflat(resid) if rcomp.ef is not None else (), step=step)
    leaves = lambda t: [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
    return leaves(rout), (leaves(rstate) if rcomp.ef is not None else [])


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("name,kw", CASES, ids=CASE_IDS)
def test_execute_matches_reference_bitwise(name, kw, step, reference_draw):
    rplan, plan, treedef = _plans(**PLAN_KW)
    grads, resid = _tensors(plan, 10 + step), _tensors(plan, 20 + step, 0.1)
    comp, s, out, state = _execute_port(name, kw, plan, grads, resid, step)
    rout, rstate = _execute_reference(name, kw, rplan, treedef, grads, resid, step)
    if comp.ef is None:
        assert state == ()
    assert len(out) == len(rout) and len(state) == len(rstate)
    for a, b in zip(list(out) + list(state), rout + rstate):
        np.testing.assert_array_equal(a.numpy(), b)
    nonzero = sum(int((a != 0).sum()) for a in out)
    total = sum(a.numel() for a in out)
    assert 0 < nonzero < total / 3


def test_dgc_binding_clip_matches_reference():
    """DGC's default clip (1.0) binds on these gradients; the norm's squares
    are summed in another order, so values are held at rtol 1e-6 (atol
    1e-6 of the largest synced value for the residual, ``t - sent``)."""
    rplan, plan, treedef = _plans(**PLAN_KW)
    grads, resid = _tensors(plan, 5), _tensors(plan, 6, 0.1)
    _, _, out, state = _execute_port("dgc", {}, plan, grads, resid, 0)
    rout, rstate = _execute_reference("dgc", {}, rplan, treedef, grads, resid, 0)
    top = max(float(np.abs(b).max()) for b in rout)
    assert 0 < top < 1.0                      # clipped: |values| far below |t|
    for a, b in zip(out, rout):
        np.testing.assert_array_equal(a.numpy() != 0, b != 0)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6)
    for a, b in zip(state, rstate):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6 * top)


@pytest.mark.parametrize("step", [0, 2])
@pytest.mark.parametrize("name", NAMES)
def test_arena_equals_per_bucket_bitwise(name, step):
    _, plan, _ = _plans(**PLAN_KW)
    grads, resid = _tensors(plan, 30 + step), _tensors(plan, 40 + step, 0.1)
    _, _, out, state = _execute_port(name, {}, plan, grads, resid, step)
    _, _, aout, astate = _execute_port(name, {}, plan, grads, resid, step,
                                       use_arena=True)
    assert all(torch.equal(a, b) for a, b in zip(aout + astate, out + state))


def test_randomk_draw_is_deterministic_and_uniform():
    stage = RandomK(0.05)
    key = BucketKey(0, 7, 3)
    a, b = stage.indices(key, 5000, "cpu"), stage.indices(BucketKey(0, 7, 3), 5000, "cpu")
    assert a.shape == (250,) and torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 5000
    others = [BucketKey(1, 7, 3), BucketKey(0, 8, 3), BucketKey(0, 7, 4)]
    assert all(not torch.equal(a, stage.indices(k, 5000, "cpu")) for k in others)
    assert len({k.value for k in [key] + others}) == 4
    # uniform: 200 draws of 10,000 indices into 20 bins, chi-square at 19
    # degrees of freedom below its 99.9% point (43.8)
    big = RandomK(1.0)
    counts = torch.zeros(20)
    for s in range(20):
        idx = big.indices(BucketKey(0, s, 0), 10_000, "cpu")
        counts += torch.bincount(idx // 500, minlength=20).float()
    expected = 20 * 10_000 / 20
    assert float(((counts - expected) ** 2 / expected).sum()) < 43.8
    # the whole step: the same key gives the same result
    _, plan, _ = _plans(**PLAN_KW)
    grads, resid = _tensors(plan, 1), _tensors(plan, 2, 0.1)
    _, _, o1, r1 = _execute_port("randomk", {"ratio": 0.05}, plan, grads, resid, 7)
    _, _, o2, r2 = _execute_port("randomk", {"ratio": 0.05}, plan, grads, resid, 7)
    _, _, o3, _ = _execute_port("randomk", {"ratio": 0.05}, plan, grads, resid, 8)
    assert all(torch.equal(x, y) for x, y in zip(o1 + r1, o2 + r2))
    assert not all(torch.equal(x, y) for x, y in zip(o1, o3))


@pytest.fixture
def one_rank_gloo(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_oktopk_one_rank_group_equals_no_group_and_topk(one_rank_gloo):
    rng = np.random.default_rng(4)
    for n in (1000, 4097, 65_536):
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        routed = OkTopKRoute(0.01).execute_bucket(x, None, one_rank_gloo)
        local = OkTopKRoute(0.01).execute_bucket(x, None, None)
        top = TopK(0.01).execute_bucket(x, None, one_rank_gloo)
        for a, b, c in zip(routed, local, top):
            assert torch.equal(a, b) and torch.equal(a, c)
        assert int((routed[0] != 0).sum()) == math.ceil(n * 0.01)


# ---------------------------------------------------------------------------
# several gloo workers against numpy oracles
# ---------------------------------------------------------------------------

def _oracle_topk(xs, ratio):
    W, n = len(xs), len(xs[0])
    m = max(1, math.ceil(n * ratio))
    out, sent = np.zeros(n, np.float32), []
    for x in xs:
        idx = np.argsort(-np.abs(x), kind="stable")[:m]
        s = np.zeros(n, np.float32)
        s[idx] = x[idx]
        out[idx] += x[idx]
        sent.append(s)
    return [out / np.float32(W)] * W, sent


def _oracle_randomk(xs, idx):
    W, n = len(xs), len(xs[0])
    mean = sum(x[idx] for x in xs) / np.float32(W)
    out = np.zeros(n, np.float32)
    out[idx] = mean
    sent = []
    for x in xs:
        s = np.zeros(n, np.float32)
        s[idx] = x[idx]
        sent.append(s)
    return [out] * W, sent


def _oracle_oktopk(xs, ratio):
    """Ok-topk's exchange, entry by entry: each worker routes its local
    top-m, by descending magnitude, to the owner of each entry's region
    while the window for that owner has room; each owner sums what it
    received (senders in rank order) and keeps its top-(m/W); the
    survivors, divided by W, form every worker's result."""
    W, n = len(xs), len(xs[0])
    m = int(math.ceil(max(W, math.ceil(n * ratio)) / W) * W)
    region = math.ceil(n / W)
    cap = min(2 * m // W + 1, region)
    dense = [np.zeros(region, np.float32) for _ in range(W)]
    sent, dropped = [], 0
    for x in xs:
        used = [0] * W
        s = np.zeros(n, np.float32)
        for i in np.argsort(-np.abs(x), kind="stable")[:m]:
            r = i // region
            if used[r] < cap:
                dense[r][i - r * region] += x[i]
                s[i] = x[i]
                used[r] += 1
            else:
                dropped += 1
        sent.append(s)
    out = np.zeros(region * W, np.float32)
    for r in range(W):
        keep = np.argsort(-np.abs(dense[r]), kind="stable")[:m // W]
        out[r * region + keep] = dense[r][keep]
    return [(out / np.float32(W))[:n]] * W, sent, dropped


@pytest.mark.parametrize("world", [2, 3])
def test_sparse_exchanges_on_gloo_match_numpy_oracles(tmp_path, world):
    n, ratio = 3001, 0.02
    rng = np.random.default_rng(world)
    xs = [rng.standard_normal(n).astype(np.float32) for _ in range(world)]
    if world == 3:
        # worker 0's largest entries crowd into region 0: its window there
        # overflows
        xs[0][:300] *= 50
    np.savez(tmp_path / "in.npz", **{f"x{r}": x for r, x in enumerate(xs)})
    ctx = mp.start_processes(sparse_worker, args=(
        world, str(tmp_path / "rdv"), str(tmp_path / "in.npz"), str(tmp_path / "out"),
        ratio), nprocs=world, join=False, start_method="spawn")
    for _ in range(120):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        raise AssertionError("gloo workers did not finish within 120 s")
    got = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]
    idx = got[0]["randomk/idx"]
    assert all(np.array_equal(g["randomk/idx"], idx) for g in got)
    ok_out, ok_sent, dropped = _oracle_oktopk(xs, ratio)
    assert (dropped > 0) == (world == 3)
    oracles = {"topk": _oracle_topk(xs, ratio), "randomk": _oracle_randomk(xs, idx),
               "oktopk": (ok_out, ok_sent)}
    for name, (out, sent) in oracles.items():
        for r, g in enumerate(got):
            np.testing.assert_array_equal(g[f"{name}/sent"], sent[r], err_msg=name)
            np.testing.assert_allclose(g[f"{name}/synced"], out[r], rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name} rank {r}")
        for g in got[1:]:
            np.testing.assert_array_equal(g[f"{name}/synced"], got[0][f"{name}/synced"])


# ---------------------------------------------------------------------------
# trainer runs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_trainer_matches_reference(name, reference_draw):
    """5 SGD steps on REDUCED from the same parameters and batches: losses
    at rtol 1e-5; params, momenta and residuals at the trainer tests'
    bound (rtol 1e-4, atol 1e-6)."""
    tc = dict(TC, compressor=name)
    rtr = RTrainer(r_build_model(rconfigs.get_reduced("gpt2-paper")),
                   r_sgd(LR, momentum=0.9), RTrainConfig(**tc))
    rstate = rtr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, rstate["params"])
    rstate = rtr.run(rstate, iter(r_make_loader(RDataConfig(**DATA))), log=None)
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu")
    model.load_state_dict(params_from_jax(init, device="cpu"))
    tr = Trainer(model, sgd(LR, momentum=0.9), TrainConfig(**tc))
    state = tr.run(tr.init_state(), make_loader(DataConfig(**DATA), device="cpu"),
                   log=None)
    assert tr.schedule_report() == rtr.schedule_report()
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in rtr.history], rtol=1e-5)
    want = {part: [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
            for part, tree in (("params", rstate["params"]),
                               ("mu", rstate["opt"]["mu"]), ("resid", rstate["comp"]))}
    got = {"params": [p.detach().numpy() for p in state["params"]],
           "mu": [m.numpy() for m in state["opt"]["mu"]],
           "resid": [r.numpy() for r in state["comp"]]}
    for part in want:
        for a, b, path in zip(got[part], want[part], tr.leaf_names):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} {part} {path}")


@pytest.mark.parametrize("name", NAMES)
def test_fused_overlap_and_sharded_sync_refuse(name):
    comp = get_compressor(name)
    assert not supports_fused_overlap(comp) and not supports_sharded_sync(comp)
    with pytest.raises(ValueError, match="sync='sharded'"):
        get_compressor(name, sync="sharded")
    with pytest.raises(ValueError):
        r_get_compressor(name, sync="sharded")
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu")
    with pytest.raises(ValueError, match="overlap='fused'"):
        Trainer(model, sgd(LR), TrainConfig(compressor=name, overlap="fused"))
    with pytest.raises(ValueError, match="sync='sharded'"):
        Trainer(model, sgd(LR), TrainConfig(compressor=name, sync="sharded"))


def test_bucket_key_seeds_differ_across_steps_and_buckets():
    seeds = {BucketKey(s, t, b).value for s in range(3) for t in range(50)
             for b in range(40)}
    assert len(seeds) == 3 * 50 * 40
    assert all(0 <= v < 2 ** 63 for v in seeds)
    comp = get_compressor("randomk", seed=5)
    assert comp.bucket_key(9, 2) == BucketKey(5, 9, 2)
    assert stages.BucketKey is BucketKey
