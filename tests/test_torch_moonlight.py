"""moonlight-16b-a3b (DeepSeek-V3's architecture) in the port, on the CPU at
small sizes, against the benchmark's plain reference
``bench/reference/moonlight.py`` (the JAX package has no such model):
latent attention's forward and gradients; the sigmoid router's choices,
weights and sequence-wise loss; an expert share (two shares' outputs, the
shared expert counted once, add up to the whole layer's); the whole model's loss, aux loss, gradients and leaf order, with
and without a share; three COVAP steps against the benchmark's reference
cycle; the arena, sharded and fused forms equal to post bit for bit; the
latent-attention spans and the ``moe/held`` counter in a profiled step; the
other MoE and dense configurations' steps unchanged (the same ATen
operations on the same shapes, in the same order); decoding refused for
want of a latent cache; the FLOPs, stages, dry run, CLI and plan report."""
import dataclasses
import hashlib
import math

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.configs as tconfigs
from bench.reference import moonlight as ref
from repro_torch.configs.base import InputShape
from repro_torch.core import build_plan
from repro_torch.core.bucketing import EMBED_STAGE, bucket_first_use
from repro_torch.data import DataConfig, make_loader
from repro_torch.launch import analytic_costs, dryrun
from repro_torch.launch import train as cli
from repro_torch.models import attention, build_model, moe
from repro_torch.models.layers import mlp
from repro_torch.obs import spans
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train import TrainConfig, Trainer

torch.set_num_threads(2)

ARCH = "moonlight-16b-a3b"
# loss and gradients: the program's chunked attention and token-major
# combine sum in another order than the reference's blocks and loops
RTOL, ATOL = 1e-4, 1e-6
B, S = 2, 64                 # two attention chunks and two xent chunks of 32
SMALL = tconfigs.get_reduced(ARCH)
# the benchmark configuration's share at small size: 4 of 8 experts held
SHARE = SMALL.with_(num_experts=4, n_routed_experts=8, first_expert=0)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _model(cfg, seed=0):
    """The port's model with every norm scale perturbed off zero, so that
    ``1 + scale`` is tested."""
    model = build_model(cfg, device="cpu", seed=seed)
    g = _gen(seed + 1)
    with torch.no_grad():
        for path, p in model.named_leaves():
            if path.endswith(".scale"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


def _ref_params(model):
    return {path: p.detach().clone().requires_grad_(True) for path, p in model.named_leaves()}


def _tokens(cfg, seed=3):
    g = _gen(seed)
    return (torch.randint(0, cfg.vocab_size, (B, S), generator=g),
            torch.randint(0, cfg.vocab_size, (B, S), generator=g))


def _arch(cfg):
    return ref.Arch.from_config(dataclasses.asdict(cfg))


def _row(tree, i=0):
    return {k: _row(v, i) for k, v in tree.items()} if hasattr(tree, "items") else tree[i]


def test_registry_lists_moonlight_after_the_reference_archs():
    assert tconfigs.list_archs()[-1] == ARCH
    assert ARCH in tconfigs.PORT_ONLY and ARCH not in tconfigs.reference_archs()
    assert tconfigs.list_archs(assigned_only=True)[-1] == ARCH
    full = tconfigs.get_config(ARCH)
    assert full.param_count() == 15_960_108_544
    assert (full.is_mla, full.routed_experts, full.num_layers) == (True, 64, 27)


def test_mla_forward_and_gradients_equal_the_reference():
    model = _model(SMALL)
    p = _row(model.stack["dense"])["attn"]
    x = torch.randn(B, S, SMALL.d_model, generator=_gen(5), requires_grad=True)
    y = attention.attn_train(p, x, SMALL)
    xr = x.detach().clone().requires_grad_(True)
    pr = {f"attn.{k}": v.detach().clone().requires_grad_(True)
          for k, v in [("wq", p["wq"]), ("wkv_a", p["wkv_a"]), ("wkv_b", p["wkv_b"]),
                       ("wo", p["wo"]), ("kv_norm.scale", p["kv_norm"]["scale"])]}
    yr = ref.attention(pr, xr, _arch(SMALL), torch.matmul)
    torch.testing.assert_close(y, yr, rtol=RTOL, atol=ATOL)
    # a loss-sized scalar: a random projection of each token's output,
    # averaged over the tokens
    w = torch.randn(y.shape, generator=_gen(6))
    (y * w).sum(-1).mean().backward()
    (yr * w).sum(-1).mean().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=RTOL, atol=ATOL)
    for name in ("wq", "wkv_a", "wkv_b", "wo"):
        got = model.stack["dense"]["attn"][name].grad[0]
        torch.testing.assert_close(got, pr[f"attn.{name}"].grad, rtol=RTOL, atol=ATOL,
                                   msg=name)
    got = model.stack["dense"]["attn"]["kv_norm"]["scale"].grad[0]
    torch.testing.assert_close(got, pr["attn.kv_norm.scale"].grad, rtol=RTOL, atol=ATOL)


def test_mla_shapes_and_refusals():
    shapes = attention.mla_param_shapes(tconfigs.get_config(ARCH))
    assert shapes == {"wq": (2048, 16 * 192), "wkv_a": (2048, 576), "kv_norm.scale": (512,),
                      "wkv_b": (512, 16 * 256), "wo": (2048, 2048)}
    with pytest.raises(NotImplementedError, match="q_lora_rank"):
        attention.mla_param_shapes(SMALL.with_(q_lora_rank=8))


def _explicit_route(xt, w, cfg, rows):
    """The DeepSeek-V3 router written out, a row at a time."""
    E, k = cfg.routed_experts, cfg.experts_per_token
    s = torch.sigmoid(xt @ w)
    top_s, top_e = torch.topk(s, k, dim=-1)
    weights = top_s / top_s.sum(-1, keepdim=True) * cfg.routed_scaling_factor
    T = xt.shape[0] // rows
    losses = []
    for r in range(rows):
        sr, er = s[r * T:(r + 1) * T], top_e[r * T:(r + 1) * T]
        P = (sr / sr.sum(-1, keepdim=True)).mean(0)
        f = torch.stack([(er == i).sum() for i in range(E)]).float() * E / (k * T)
        losses.append(cfg.aux_loss_coef * (f * P).sum())
    return top_e, weights, torch.stack(losses).mean()


@pytest.mark.parametrize("cfg", [SMALL, SHARE], ids=["whole", "share"])
def test_sigmoid_router_choices_weights_and_sequence_loss(cfg):
    w = torch.randn(cfg.d_model, cfg.routed_experts, generator=_gen(7))
    xt = torch.randn(B * S, cfg.d_model, generator=_gen(8))
    scores, top_p, top_e, aux = moe.route({"router": w}, xt, cfg, B)
    want_e, want_w, want_aux = _explicit_route(xt, w, cfg, B)
    assert torch.equal(top_e, want_e)
    torch.testing.assert_close(top_p, want_w, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(top_p.sum(-1), torch.full((B * S,), cfg.routed_scaling_factor),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(aux, want_aux, rtol=1e-6, atol=1e-9)
    assert torch.equal(scores, torch.sigmoid(xt @ w))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _moe_params(model_cfg, seed=11):
    model = _model(model_cfg, seed=seed)
    return _row(model.stack["blocks"]["b0"])["moe"]


def _share_params(p, first, count):
    out = dict(p)
    for name in ("w_gate", "w_up", "w_down"):
        out[name] = p[name][first:first + count]
    return out


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_two_shares_add_up_to_the_whole_layer(cf):
    """Experts 0-3 and 4-7 of 8, each share with the shared expert, less
    the shared expert once, give the uncut layer's output; the aux loss is
    every share's alike; the uncut and the share equal the reference's."""
    whole = SMALL.with_(moe_capacity_factor=cf)
    p = _moe_params(whole)
    x = torch.randn(B, S, whole.d_model, generator=_gen(12))
    y, aux = moe.moe_apply(p, x, whole)
    parts = []
    for first in (0, 4):
        cfg = whole.with_(num_experts=4, n_routed_experts=8, first_expert=first)
        yp, auxp = moe.moe_apply(_share_params(p, first, 4), x, cfg)
        assert torch.equal(auxp, aux)
        parts.append(yp)
        a = _arch(cfg)
        pr = {f"moe.{k}": v for k, v in _flat(_share_params(p, first, 4)).items()}
        yr, auxr, _ = ref.moe(pr, x, a, torch.matmul)
        torch.testing.assert_close(yp, yr, rtol=RTOL, atol=ATOL)
    shared = mlp(p["shared"], x.reshape(-1, whole.d_model), whole.mlp_act, torch.float32)
    torch.testing.assert_close(parts[0] + parts[1] - shared.reshape(x.shape), y,
                               rtol=RTOL, atol=ATOL)
    yr, auxr, dropped = ref.moe({f"moe.{k}": v for k, v in _flat(p).items()}, x, _arch(whole),
                                torch.matmul)
    torch.testing.assert_close(y, yr, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(aux, auxr, rtol=1e-6, atol=1e-9)
    assert (dropped > 0) == (cf < 1)


def test_a_share_dispatches_only_its_experts():
    cfg = SHARE.with_(first_expert=4)
    top_e = torch.tensor([[4, 0], [7, 5], [1, 4], [4, 6]])
    slot, keep = moe.dispatch(top_e, cfg, 2)
    # capacity 2 an expert; expert 4's third assignment is dropped, and
    # every assignment to experts 0-3 goes to the dropped slot 4 * 2
    assert keep.tolist() == [True, False, True, True, False, True, False, True]
    assert slot.tolist() == [0, 8, 6, 2, 8, 1, 8, 4]
    assert moe.held(top_e, cfg).sum() == 6


@pytest.mark.parametrize("cfg", [SMALL, SHARE], ids=["whole", "share"])
def test_model_loss_aux_and_gradients_equal_the_reference(cfg):
    model = _model(cfg)
    params = _ref_params(model)
    a = _arch(cfg)
    assert list(params) == list(ref.param_shapes(a))
    assert [tuple(v.shape) for v in params.values()] == list(ref.param_shapes(a).values())
    tokens, labels = _tokens(cfg)
    total, metrics = model.loss_fn({"tokens": tokens, "labels": labels})
    total.backward()
    rtotal, xent, aux, _ = ref.loss(params, tokens, labels, a)
    rtotal.backward()
    assert float(total) == pytest.approx(float(rtotal), rel=1e-5)
    assert float(metrics["aux_loss"]) == pytest.approx(float(aux), rel=1e-5, abs=1e-8)
    assert float(metrics["aux_loss"]) > 0
    for (path, p), r in zip(model.named_leaves(), params.values()):
        torch.testing.assert_close(p.grad, r.grad, rtol=RTOL, atol=ATOL, msg=path)


def test_three_covap_steps_equal_the_benchmark_reference(tmp_path):
    """Three COVAP (I=4, post) steps of the share through ``Trainer.step``
    from the benchmark's seeded weights, against the benchmark's reference
    cycle: each step's loss, and each leaf's first sent gradient and change
    by norm."""
    import json

    from bench import check, weights
    from bench.reference import train as ref_train

    conf = dict(dataclasses.asdict(SHARE), reference="moonlight", vocab_size=300,
                optimizer={"name": "adamw", "lr": 1e-3, "b1": 0.9, "b2": 0.999,
                           "eps": 1e-8, "weight_decay": 0.0, "moment_dtype": "float32"})
    traffic = {"seq_len": 32, "rows_per_chip": 4, "compressor": "covap", "interval": 4,
               "overlap": "post", "arena": False, "sync": "allreduce", "bucket_bytes": 4096,
               "max_buckets": 128}
    seed = 2**31 + 29
    cfg = SHARE.with_(vocab_size=300)
    model = build_model(cfg, device="cpu")
    paths = [p for p, _ in model.named_leaves()]
    for i, (path, p) in enumerate(model.named_leaves()):
        weights.fill_leaf(p.data, seed, i, path)
    o = conf["optimizer"]
    tc = TrainConfig(compressor="covap", interval=4, overlap="post",
                     bucket_bytes=traffic["bucket_bytes"], max_buckets=traffic["max_buckets"])
    tr = Trainer(model, adamw(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                              weight_decay=0.0), tc)
    state = tr.init_state()
    loader = iter(make_loader(DataConfig(vocab_size=300, seq_len=32, global_batch=4,
                                         seed=seed), device="cpu"))
    first = [torch.zeros_like(p) for p in state["params"]]
    losses = []
    for _ in range(3):
        state, metrics = tr.step(state, next(loader))
        losses.append(float(metrics["total_loss"]))
        ref_train.first_sent(first, state["opt"]["m"], o["b1"])
    change = [float(torch.linalg.vector_norm(p - weights.fill_leaf(torch.empty_like(p), seed,
                                                                   i, path)))
              for i, (path, p) in enumerate(zip(paths, state["params"]))]
    prog = {"loss": losses, "grad": [float(torch.linalg.vector_norm(g)) for g in first],
            "sketch": [[0.0] for _ in first], "change": change}
    want = ref_train.run(conf, traffic, seed=seed, workers=1, device="cpu", steps=3)
    want["sketch"] = [[0.0] for _ in first]
    found = check.gaps([prog], want)
    limits = {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-3}
    assert check.verdict(found, limits), json.dumps(found)


@pytest.fixture
def one_rank_gloo(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


FORMS = {"arena": dict(arena=True), "sharded": dict(sync="sharded"),
         "fused": dict(overlap="fused"),
         "fused-sharded-arena": dict(overlap="fused", sync="sharded", arena=True)}
TC = dict(compressor="covap", interval=4, bucket_bytes=1 << 14, max_buckets=32,
          log_every=1, steps=5)
DATA = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)
_POST: dict = {}


def _run(cfg, group, **tc):
    model = build_model(cfg, device="cpu")
    tr = Trainer(model, adamw(cosine_warmup(1e-3, 1, 5)), TrainConfig(**dict(TC, **tc)),
                 group=group)
    state = tr.run(tr.init_state(), make_loader(DataConfig(**DATA), device="cpu"), log=None)
    return tr, state


@pytest.mark.parametrize("form", sorted(FORMS))
def test_forms_equal_post_bitwise(form, one_rank_gloo):
    """The share's arena, sharded and fused forms against its post path
    over a cycle and a step, in a one-rank gloo group: the dense prefix is
    stage 0 of the head gather, the MoE superblocks stages 1 and 2."""
    if "post" not in _POST:
        _POST["post"] = _run(SHARE, one_rank_gloo)
    tp, sp = _POST["post"]
    cfg = SHARE.with_(remat=True) if "fused" in form else SHARE
    tf, sf = _run(cfg, one_rank_gloo, **FORMS[form])
    assert [h["total_loss"] for h in tf.history] == [h["total_loss"] for h in tp.history]
    for part in ("params", "comp"):
        for a, b in zip(sf[part], sp[part]):
            assert torch.equal(a, b), part
    for key in ("m", "v"):
        for a, b in zip(sf["opt"][key], sp["opt"][key]):
            assert torch.equal(a, b), key
    assert tf.model.num_stages == 3
    if "sharded" in form:
        layers = [i for kind, i in tf.gather_events if kind == "layer"]
        assert layers == list(range(4))


def test_stages_put_the_dense_prefix_first():
    model = build_model(SHARE, device="meta")
    plan = build_plan(model.named_leaves(), bucket_bytes=4096, max_buckets=128, interval=1)
    stages = bucket_first_use(plan)

    def stage(path, seg):
        if path.startswith("stack.dense."):
            return seg.row_lo
        if path.startswith("stack.blocks."):
            return 1 + seg.row_lo
        if path.startswith(("stack.final_norm.", "head.")):
            return model.num_stages
        assert path.startswith("embed.")
        return EMBED_STAGE

    for bucket, got in zip(plan.buckets, stages):
        assert got == min(stage(plan.leaf_paths[s.leaf_idx], s) for s in bucket.segments)
    assert sorted(set(stages)) == [EMBED_STAGE, 0, 1, 2, 3]


def test_profiled_step_has_the_latent_spans_and_held_counter(one_rank_gloo):
    model = build_model(SHARE, device="cpu", seed=0)
    tr = Trainer(model, adamw(1e-3), TrainConfig(bucket_bytes=1 << 13, max_buckets=64),
                 group=one_rank_gloo)
    state = tr.init_state()
    batch = next(iter(make_loader(DataConfig(**DATA), device="cpu")))
    spans.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step(state, batch)
    names = [e.name for e in prof.events()]
    totals = spans.counters()
    spans.reset_counters()
    # one MLA block a layer: the dense one and two MoE ones
    assert names.count("mla/latent") == names.count("mla/attend") == 3
    tokens = DATA["global_batch"] * DATA["seq_len"]
    assert totals["moe/assigned"] == 2 * tokens * SHARE.experts_per_token
    assert 0 < totals["moe/held"] < totals["moe/assigned"]
    assert 0 <= totals["moe/dropped"] <= totals["moe/held"]


# each REDUCED configuration's training step (loss and backward) as the
# ATen operations it dispatches, with their operands' shapes: the sha256 of
# the list, as the code before latent attention, the sigmoid router, the
# dense prefix and the expert share dispatched it
UNCHANGED = {"deepseek-moe-16b": (1170, "a74ea5e9b89e9acd"),
             "grok-1-314b": (1110, "508d49511ffe5e80"),
             "gpt2-paper": (914, "3010781e0f78c3ba")}


@pytest.mark.parametrize("arch", sorted(UNCHANGED))
def test_other_configs_dispatch_what_they_did(arch):
    cfg = tconfigs.get_reduced(arch)
    model = build_model(cfg, device="cpu", seed=3)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), generator=_gen(1))
    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ops.append(f"{func}{[tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]}")
            return out

    with Record():
        total, _ = model.loss_fn({"tokens": tok, "labels": tok})
        total.backward()
    digest = hashlib.sha256("\n".join(ops).encode()).hexdigest()[:16]
    assert (len(ops), digest) == UNCHANGED[arch]


def test_decoding_is_refused_for_want_of_a_latent_cache():
    model = build_model(SMALL, device="cpu")
    p = _row(model.stack["dense"])["attn"]
    x = torch.zeros(1, 1, SMALL.d_model)
    with pytest.raises(NotImplementedError, match="latent cache"):
        attention.attn_decode(p, x, {}, torch.zeros(1, dtype=torch.long), SMALL)
    with pytest.raises(NotImplementedError, match="latent cache"):
        attention.init_cache(SMALL, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="latent cache"):
        model.init_caches(1, 16)
    with pytest.raises(NotImplementedError, match="latent cache"):
        Engine(model, None, ServeConfig(batch_slots=2, max_len=32, max_new_tokens=4))


def test_step_flops_count_latent_attention_the_dense_layer_and_the_share():
    cfg = tconfigs.get_config(ARCH).with_(num_layers=5, num_experts=32, n_routed_experts=64)
    conf = dataclasses.asdict(cfg)
    for rows, seq in ((2, 8192), (8, 1024)):
        got = analytic_costs.step_flops(cfg, InputShape("x", seq, rows, "train"))
        assert got == pytest.approx(ref.step_flops(conf, rows=rows, seq_len=seq), rel=1e-12)
    assert ref.step_flops(conf, rows=2, seq_len=8192) == pytest.approx(73.920682e12, rel=1e-8)
    # the share: the routed experts at half the load of the whole layer's
    whole = dataclasses.asdict(cfg.with_(num_experts=64))
    d, ff, N = 2048, 1408, 2 * 8192
    held_half = 3 * 4 * 2.0 * N * 3 * d * ff * 6 * 0.5
    assert ref.step_flops(whole, rows=2, seq_len=8192) - ref.step_flops(
        conf, rows=2, seq_len=8192) == pytest.approx(held_half, rel=1e-12)
    assert cfg.param_count() == 1_986_159_104


def test_the_tools_run_moonlight():
    rec = dryrun.run_one(ARCH, "train_4k", "w8")
    assert rec["status"] in ("ok", "does_not_fit"), rec.get("error")
    assert rec["memory_analysis"]["peak_memory_in_bytes"] > 0
    rec = dryrun.run_one(ARCH, "decode_32k", "w8")
    assert rec["status"] == "error" and "latent cache" in rec["error"]


def test_cli_and_plan_report_on_reduced(capsys):
    import repro_torch.api as api

    cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2", "--seq-len", "16",
              "--global-batch", "4", "--interval", "2"])
    out = capsys.readouterr().out
    assert "[done] step 2" in out and "aux_loss" in out
    report = api.plan_report(ARCH, reduced=True)
    assert report["arch"] == ARCH and report["num_buckets"] >= 1
    assert math.isfinite(report["analytic_ccr"])
