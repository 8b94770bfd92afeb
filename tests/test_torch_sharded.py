"""Sharded sync in the port: its static schedules against the reference's,
two gloo workers running ``sync="sharded"`` against ``sync="allreduce"``
through ``Trainer.run`` (params, EF residuals and Adam moments after the
run's flush), the asynchronous head all-gather against the blocking one
(bitwise, and the order of its waits against the layers), and the model's
``before_layer`` callback on one worker."""
import os

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.core import get_compressor as r_get_compressor
from repro.models import build_model as r_build_model

import repro_torch.configs as tconfigs
from repro_torch.core import build_plan, get_compressor
from repro_torch.core.overlap import supports_sharded_sync
from repro_torch.data import DataConfig, make_loader
from repro_torch.models import build_model
from repro_torch.models import transformer
from repro_torch.models.layers import embed
from repro_torch.optim import adamw
from repro_torch.train import TrainConfig, Trainer

from _torch_dist_worker import EVENT_KINDS, gather_worker, train_worker

WORLD = 2
STEPS = 5
TC = dict(compressor="covap", interval=4, bucket_bytes=1 << 14, max_buckets=32,
          log_every=1, steps=STEPS)
DATA = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)
BF16 = {"compressor_options": {"wire_dtype": "bfloat16"}}
CLIP = 0.05          # below every step's grad norm, so the clip binds
RUNS = {
    "allreduce": TC,
    "sharded": dict(TC, sync="sharded"),
    "sharded-arena": dict(TC, sync="sharded", arena=True),
    "allreduce-bf16": dict(TC, **BF16),
    "sharded-arena-bf16": dict(TC, sync="sharded", arena=True, **BF16),
    "allreduce-clip": dict(TC, clip_norm=CLIP),
    "sharded-clip": dict(TC, sync="sharded", clip_norm=CLIP),
}


def _plans(reduced, vocab=None, **kw):
    get = "get_reduced" if reduced else "get_config"
    rcfg = getattr(rconfigs, get)("gpt2-paper")
    tcfg = getattr(tconfigs, get)("gpt2-paper")
    if vocab:
        rcfg, tcfg = rcfg.with_(vocab_size=vocab), tcfg.with_(vocab_size=vocab)
    shapes = jax.eval_shape(r_build_model(rcfg).init, jax.random.PRNGKey(0))
    return (r_build_plan(shapes, **kw),
            build_plan(build_model(tcfg, device="meta").named_leaves(), **kw))


def _call_fields(calls):
    return [(c.target, c.op, c.wire_dtype, c.payload_bytes, c.deferred)
            for c in calls]


@pytest.mark.parametrize("wire", [None, "bfloat16"])
@pytest.mark.parametrize("phase", range(4))
def test_full_width_sharded_schedule_equals_reference(phase, wire):
    rplan, plan = _plans(False)
    kw = {"interval": 4, "sync": "sharded"}
    if wire:
        kw["wire_dtype"] = wire
    r = r_get_compressor("covap", **kw).plan_phase(rplan, phase, world=8)
    p = get_compressor("covap", **kw).plan_phase(plan, phase, world=8)
    assert p.sync == r.sync == "sharded"
    assert _call_fields(p.calls) == _call_fields(r.calls)
    assert _call_fields(p.deferred_calls) == _call_fields(r.deferred_calls)
    assert p.bytes_per_worker == r.bytes_per_worker
    assert p.exposed_bytes_per_worker == r.exposed_bytes_per_worker
    assert p.deferred_bytes_per_worker == r.deferred_bytes_per_worker
    assert p.total_bytes_per_worker == r.total_bytes_per_worker
    assert p.exposed_wire_bytes() == r.exposed_wire_bytes()
    assert p.deferred_wire_bytes() == r.deferred_wire_bytes()
    assert p.summary() == {k: v for k, v in r.summary().items() if k in p.summary()}


def test_sharded_exposed_ratio_on_the_bench5_workload():
    """``BENCH_5.json``'s workload (gpt2-paper/reduced, vocab 256, 16 KiB
    buckets, covap I=4) at W=8: the sharded path's exposed wire bytes are
    the reference's, half of the allreduce path's."""
    rplan, plan = _plans(True, vocab=256, bucket_bytes=1 << 14, max_buckets=32,
                         interval=4)

    def ratio(get, pl):
        sh = [get("covap", interval=4, sync="sharded").plan_phase(pl, p, world=8)
              for p in range(4)]
        ar = [get("covap", interval=4).plan_phase(pl, p, world=8) for p in range(4)]
        return (sum(s.exposed_wire_bytes() for s in sh)
                / sum(s.wire_bytes() for s in ar))

    assert ratio(get_compressor, plan) == ratio(r_get_compressor, rplan)
    assert ratio(get_compressor, plan) == pytest.approx(0.5, abs=1e-3)


def test_supports_sharded_sync():
    for name in ("covap", "none", "fp16"):
        assert supports_sharded_sync(get_compressor(name))
    assert not supports_sharded_sync(object())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo workers, AdamW, every run of ``RUNS`` -> [rank 0, rank 1]."""
    tmp = tmp_path_factory.mktemp("sharded")
    init = str(tmp / "init.npz")
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu", seed=0)
    np.savez(init, **{k: v.numpy() for k, v in model.state_dict().items()})
    ctx = mp.start_processes(
        train_worker,
        args=(WORLD, str(tmp / "rendezvous"), init, str(tmp / "out"),
              RUNS, DATA, "adamw", 1e-3, STEPS),
        nprocs=WORLD, join=False, start_method="spawn",
    )
    for _ in range(600):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        raise AssertionError("gloo workers did not finish within 600 s")
    assert not any(p.is_alive() for p in ctx.processes)
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]


def _keys(got, run):
    return [k[len(run) + 1:] for k in got
            if k.startswith(run + "/") and k != f"{run}/grad_norm"]


def test_two_worker_sharded_equals_allreduce_after_flush(ranks):
    """Two gloo workers, AdamW, a COVAP cycle plus one step: sharded sync
    (per-segment and arena forms) against allreduce, and the same with a
    bf16 wire.  At W=2 the mean of two values does not depend on the order
    of the sum, so the reduce-scatter gives each owned element the bits the
    all-reduce gives it: params, residuals and Adam moments are held
    BITWISE after the flush, on both ranks."""
    pairs = [("sharded", "allreduce"), ("sharded-arena", "allreduce"),
             ("sharded-arena-bf16", "allreduce-bf16")]
    for got in ranks:
        for a, b in pairs:
            keys = _keys(got, b)
            assert keys and any(k.startswith("m:") for k in keys)
            for k in keys:
                np.testing.assert_array_equal(got[f"{a}/{k}"], got[f"{b}/{k}"],
                                              err_msg=f"{a} vs {b}: {k}")
    # params and moments are replicated after the flush; residuals are not
    for k in ranks[0]:
        if "/params:" in k or "/m:" in k or "/v:" in k:
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    assert any(not np.array_equal(ranks[0][k], ranks[1][k])
               for k in ranks[0] if "/resid:" in k)
    # the bf16 wire moves the params: it is not the f32 run under another name
    assert any(not np.array_equal(ranks[0][f"allreduce/{k}"],
                                  ranks[0][f"allreduce-bf16/{k}"])
               for k in (k.split("/", 1)[1] for k in ranks[0]
                         if k.startswith("allreduce/params:")))


def test_two_worker_sharded_clip_matches_allreduce(ranks):
    """A global-norm clip that binds on every step, under sharded sync and
    under allreduce.  The sharded norm all-reduces the local square sums
    (each worker's synced grads are zero off its shards), so it sums in
    another order than the allreduce norm and may differ in its last bit;
    the clip scale then differs by one f32 ulp.  So: the reported norms
    agree to 1e-6 relative, and params, residuals and Adam moments after
    the flush to 1e-5 of each part's largest value (the clip itself moves
    them by more than 100 times that)."""
    for got in ranks:
        gn = got["allreduce-clip/grad_norm"]
        assert np.all(gn > CLIP)
        np.testing.assert_allclose(got["sharded-clip/grad_norm"], gn, rtol=1e-6)
        for part in ("params", "resid", "m", "v"):
            keys = [k for k in _keys(got, "allreduce-clip")
                    if k.startswith(part + ":")]
            assert keys
            atol = 1e-5 * max(float(np.max(np.abs(got[f"allreduce-clip/{k}"])))
                              for k in keys)
            for k in keys:
                np.testing.assert_allclose(got[f"sharded-clip/{k}"],
                                           got[f"allreduce-clip/{k}"],
                                           rtol=0, atol=atol, err_msg=k)
            assert any(np.max(np.abs(got[f"allreduce/{k}"]
                                     - got[f"allreduce-clip/{k}"])) > 100 * atol
                       for k in keys), part


# ---- the asynchronous head all-gather ----------------------------------------

def _spawn(worker, tmp, args, what):
    ctx = mp.start_processes(worker, args=(WORLD, str(tmp / "rendezvous"), *args),
                             nprocs=WORLD, join=False, start_method="spawn")
    for _ in range(600):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        raise AssertionError(f"{what}: gloo workers did not finish within 600 s")
    assert not any(p.is_alive() for p in ctx.processes)


@pytest.fixture(scope="module")
def gathers(tmp_path_factory):
    """Two gloo workers, sharded sync, AdamW: the async head gather through
    ``Trainer.step`` and the blocking one -> [rank 0, rank 1]."""
    tmp = tmp_path_factory.mktemp("gather")
    init = str(tmp / "init.npz")
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu", seed=1)
    np.savez(init, **{k: v.numpy() for k, v in model.state_dict().items()})
    _spawn(gather_worker, tmp, (init, str(tmp / "out"), dict(TC, sync="sharded"),
                                DATA, 1e-3, STEPS), "gather")
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]


def _stages():
    """Each bucket's first-use stage, from its segments: -1 (before the
    embedding) for ``embed.*``, row r (before layer r) for a stacked leaf,
    the layer count for the final norm and the head."""
    cfg = tconfigs.get_reduced("gpt2-paper")
    plan = build_plan(build_model(cfg, device="meta").named_leaves(),
                      bucket_bytes=TC["bucket_bytes"], max_buckets=TC["max_buckets"],
                      interval=TC["interval"])
    L = cfg.num_layers

    def stage(seg):
        path = plan.leaf_paths[seg.leaf_idx]
        if path.startswith("embed."):
            return -1
        if path.startswith("stack.blocks."):
            return seg.row_lo
        assert path in ("head.w", "stack.final_norm.scale"), path
        return L

    return [min(stage(s) for s in b.segments) for b in plan.buckets], L


def test_async_head_gather_is_bitwise_the_blocking_gather(gathers):
    """Every step's losses, and params, Adam moments and EF residuals after
    a COVAP cycle plus one step, before and after a final blocking gather,
    on both ranks."""
    for got in gathers:
        np.testing.assert_array_equal(got["async/losses"], got["blocking/losses"])
        keys = [k[len("blocking/"):] for k in got if k.startswith("blocking/")
                and k != "blocking/losses"]
        assert any(k.startswith("pre/m:") for k in keys)
        assert any(k.startswith("post/resid:") for k in keys)
        for k in keys:
            np.testing.assert_array_equal(got[f"async/{k}"], got[f"blocking/{k}"],
                                          err_msg=k)
    # the gather moves values: the workers disagree before it, agree after
    assert any(not np.array_equal(gathers[0][k], gathers[1][k])
               for k in gathers[0] if k.startswith("async/pre/params:"))
    for k in gathers[0]:
        if k.startswith("async/post/") and "resid:" not in k:
            np.testing.assert_array_equal(gathers[0][k], gathers[1][k], err_msg=k)


def test_async_head_gather_waits_where_each_bucket_is_first_read(gathers):
    """Every step: all buckets issued, in order of first use, before the
    forward pass reaches layer 0; each bucket waited for once, before the
    first layer that reads it and after the layer before that one, so a
    bucket of later rows is not waited for before layer 0."""
    stages, L = _stages()
    assert sorted(set(stages)) == [-1, *range(L + 1)]
    for got in gathers:
        for s in range(STEPS):
            events = [(EVENT_KINDS[k], i) for k, i in got[f"events:{s}"]]
            pos = {e: n for n, e in enumerate(events)}
            assert len(pos) == len(events)
            issues = [i for k, i in events if k == "issue"]
            assert issues == sorted(range(len(stages)), key=lambda b: (stages[b], b))
            layers = [i for k, i in events if k == "layer"]
            assert layers == list(range(L + 1))
            assert max(pos[("issue", b)] for b in issues) < pos[("layer", 0)]
            for b, f in enumerate(stages):
                at = pos[("settle", b)]
                assert at > max(pos[("issue", c)] for c in issues)
                assert at < pos[("layer", max(f, 0))], (s, b, f)
                if f >= 1:
                    assert at > pos[("layer", f - 1)], (s, b, f)


def _batch(cfg, seed=0):
    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=2, corpus_tokens=1 << 14), device="cpu")
    return loader.make(seed)


def _todays_loss(model, batch):
    """``DecoderLM.loss_fn`` with no callback, written out: the layer loop
    over ``transformer._attn_block_train``."""
    import math
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.model import _xent_chunked

    cfg = model.cfg
    cd = getattr(torch, cfg.compute_dtype)
    x = embed(model.embed["table"], batch["tokens"], cd)
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cd, device=x.device)
    blocks = model.stack["blocks"]["b0"]
    for i in range(cfg.num_layers):
        if cfg.remat:
            x = checkpoint(lambda x_, i_=i: transformer._attn_block_train(
                transformer._layer(blocks, i_), x_, cfg), x, use_reentrant=False)
        else:
            x = transformer._attn_block_train(transformer._layer(blocks, i), x, cfg)
    x = rmsnorm(model.stack["final_norm"], x, cfg.norm_eps)
    return _xent_chunked(model.head["w"], x, batch["labels"], cfg)


@pytest.mark.parametrize("remat", [False, True])
def test_before_layer_callback_changes_nothing_on_one_worker(remat):
    """With no group: the model without a callback is bitwise the
    written-out loop (loss and every gradient), with a callback the same
    again, and the callback runs once per stage, in order, also under the
    backward pass's recompute of checkpointed layers."""
    cfg = tconfigs.get_reduced("gpt2-paper").with_(remat=remat)
    model = build_model(cfg, device="cpu", seed=2)
    batch = _batch(cfg)
    params = [p for _, p in model.named_leaves()]

    def run(fn):
        for p in params:
            p.grad = None
        loss = fn()
        loss.backward()
        return loss.detach(), [p.grad.clone() for p in params]

    calls = []
    want = run(lambda: _todays_loss(model, batch))
    plain = run(lambda: model.loss_fn(batch)[0])
    hooked = run(lambda: model.loss_fn(batch, before_layer=calls.append)[0])
    assert calls == list(range(cfg.num_layers + 1))
    for got in (plain, hooked):
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_sharded_trainer_without_a_group_records_no_gather():
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu", seed=0)
    tr = Trainer(model, adamw(1e-3), TrainConfig(**dict(TC, sync="sharded")))
    state = tr.init_state()
    state, _ = tr.step(state, _batch(model.cfg))
    assert tr.gather_events == []
