"""The port's spans and counters inside the training step
(``repro_torch.obs.spans``), on the CPU.

* One post step and one fused step of REDUCED gpt2-paper under
  ``torch.profiler`` (a one-rank gloo group, so the metrics' all-reduce
  runs) give exactly the step's spans, each inside the test's step span
  and in order; the fused step has one ``covap_bucket_{b}/phase_{p}``
  span per bucket it started, each inside ``train/backward``; the MoE
  spans nest in ``train/forward``, and again in ``train/backward`` under
  ``remat`` (the recompute).
* With no profiler, ``span`` never reaches ``record_function`` (patched to
  raise) and ``count`` neither touches its value nor keeps a total.
* Steps under the profiler leave the parameters, AdamW's moments and the
  EF residuals equal, bit for bit, to the same steps without it.
* The MoE counters equal what ``dispatch``'s ``keep`` gives for the same
  tokens, with a capacity factor that drops assignments, and twice that
  under ``remat``.
"""
import contextlib
import json
import math

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch.configs as tconfigs
from repro_torch.data import DataConfig, make_loader
from repro_torch.models import build_model, moe
from repro_torch.obs import spans
from repro_torch.optim import adamw
from repro_torch.train import TrainConfig, Trainer

torch.set_num_threads(2)

SMALL = dict(bucket_bytes=1 << 13, max_buckets=64)
DATA = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)
STEP = "test/step"
PROGRAM = (STEP, "train/", "data/", "moe/", "covap_bucket_")
TRAIN = ["train/forward", "train/backward", "train/metrics", "train/sync",
         "train/optimizer"]


@pytest.fixture
def group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _trainer(group, overlap="post", arch="gpt2-paper", **cfg_kw):
    cfg = tconfigs.get_reduced(arch).with_(**cfg_kw)
    model = build_model(cfg, device="cpu", seed=0)
    tc = TrainConfig(overlap=overlap, **SMALL)
    return Trainer(model, adamw(1e-3), tc, group=group)


def _loader():
    return make_loader(DataConfig(**DATA), device="cpu")


def _profiled(fn, path):
    """``fn()`` inside a ``test/step`` span under the profiler -> the
    trace's program spans and that step span (``user_annotation`` events;
    the process group's ``gloo:*`` ranges left out)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(STEP):
            fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e.get("ph") == "X" and e["name"].startswith(PROGRAM)),
                  key=lambda e: e["ts"])


def _inside(inner, outer) -> bool:
    return outer["ts"] <= inner["ts"] and (inner["ts"] + inner["dur"]
                                           <= outer["ts"] + outer["dur"])


def _one(events, name):
    found = [e for e in events if e["name"] == name]
    assert len(found) == 1, (name, len(found))
    return found[0]


def _step(tr, state, loader, i):
    batch = loader.make(i)
    return tr.step(state, batch)


def test_post_step_spans(group, tmp_path):
    tr, loader = _trainer(group), _loader()
    state = tr.init_state()
    ev = _profiled(lambda: _step(tr, state, loader, 0), tmp_path / "t.json")
    names = [e["name"] for e in ev]
    assert names == [STEP, "data/draw", "data/copy", *TRAIN]
    step = _one(ev, STEP)
    assert all(_inside(e, step) for e in ev)
    # siblings: each span closes before the next opens
    assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(ev[1:], ev[2:]))


def test_fused_step_spans(group, tmp_path):
    tr, loader = _trainer(group, overlap="fused"), _loader()
    state = tr.init_state()
    ev = _profiled(lambda: _step(tr, state, loader, 0), tmp_path / "t.json")
    fired = tr.last_step_fn.fired
    assert len(fired) == tr.plan.num_buckets > 1
    buckets = [e for e in ev if e["name"].startswith("covap_bucket_")]
    assert [e["name"] for e in buckets] == [f"covap_bucket_{b}/phase_0" for b in fired]
    backward = _one(ev, "train/backward")
    assert all(_inside(e, backward) for e in buckets)
    top = [e["name"] for e in ev if e not in buckets]
    assert top == [STEP, "data/draw", "data/copy", "train/forward", "train/backward",
                   "train/sync", "train/metrics", "train/optimizer"]


@pytest.mark.parametrize("remat", [False, True])
def test_moe_spans_nest_in_the_passes(group, tmp_path, remat):
    tr, loader = _trainer(group, arch="deepseek-moe-16b", remat=remat), _loader()
    state = tr.init_state()
    spans.reset_counters()
    ev = _profiled(lambda: _step(tr, state, loader, 0), tmp_path / "t.json")
    layers = tr.model.cfg.num_layers
    want = ["moe/route", "moe/dispatch", "moe/experts", "moe/combine", "moe/experts"]
    forward, backward = _one(ev, "train/forward"), _one(ev, "train/backward")
    for outer, n in ((forward, layers), (backward, layers if remat else 0)):
        inside = [e["name"] for e in ev if e["name"].startswith("moe/") and _inside(e, outer)]
        assert inside == want * n
    assert spans.counters()["moe/assigned"] > 0
    spans.reset_counters()


def test_no_profiler_no_record_function(group, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    spans.reset_counters()
    loader = _loader()
    for overlap, arch in (("post", "gpt2-paper"), ("fused", "gpt2-paper"),
                          ("post", "deepseek-moe-16b")):
        tr = _trainer(group, overlap=overlap, arch=arch)
        _step(tr, tr.init_state(), loader, 0)
    assert not spans.recording()
    assert spans.span("a") is spans.span("b")

    class Untouchable:
        def __getattribute__(self, name):
            raise AssertionError(f"count read .{name} with no profiler")

    spans.count("moe/dropped", Untouchable())
    assert spans.counters() == {}


def test_count_adds_while_recording():
    spans.reset_counters()
    calls = []
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.recording()
        spans.count("n", 3)
        spans.count("n", torch.tensor(4))
        spans.count("m", torch.tensor(2.5))
        spans.count("m", lambda: calls.append(1) or torch.tensor([1.0, 0.5]))
        assert not calls                   # kept, not called, inside the window
    spans.count("n", 100)              # after the profiler: not counted
    assert spans.counters() == {"n": 7.0, "m": 4.0}
    assert calls == [1]
    spans.reset_counters()
    assert spans.counters() == {}


def _leaves(state):
    return (list(state["params"]) + list(state["opt"]["m"]) + list(state["opt"]["v"])
            + list(state["comp"]))


@pytest.mark.parametrize("overlap,arch", [("post", "gpt2-paper"), ("fused", "gpt2-paper"),
                                          ("post", "deepseek-moe-16b")])
def test_profiled_steps_equal_unprofiled_bitwise(group, overlap, arch):
    runs = []
    for profiled in (False, True):
        tr, loader = _trainer(group, overlap=overlap, arch=arch), _loader()
        state = tr.init_state()
        with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
            for i in range(tr.num_phases + 1):
                state, _ = _step(tr, state, loader, i)
        runs.append(_leaves(state))
    spans.reset_counters()
    plain, traced = runs
    assert len(plain) == len(traced)
    for i, (a, b) in enumerate(zip(plain, traced)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8)), i


def _moe_params(cfg, gen):
    shapes = moe.moe_param_shapes(cfg)
    flat = {k: torch.randn(s, generator=gen) / math.sqrt(s[-2]) for k, s in shapes.items()}
    shared = {k.split(".", 1)[1]: v for k, v in flat.items() if k.startswith("shared.")}
    params = {k: v for k, v in flat.items() if not k.startswith("shared.")}
    params["shared"] = shared
    return params


@pytest.mark.parametrize("remat", [False, True])
def test_moe_counters_equal_dispatch_keep(remat):
    cfg = tconfigs.get_reduced("deepseek-moe-16b").with_(moe_capacity_factor=0.5)
    gen = torch.Generator().manual_seed(3)
    params = _moe_params(cfg, gen)
    x = torch.randn(2, 16, cfg.d_model, generator=gen, requires_grad=True)
    xt = x.detach().reshape(-1, cfg.d_model)
    _, _, top_e, _ = moe.route(params, xt, cfg)
    _, keep = moe.dispatch(top_e, cfg, moe.capacity(cfg, xt.shape[0]))
    assert 0 < int((~keep).sum()) < keep.numel()

    def apply(x_):
        return moe.moe_apply(params, x_, cfg)[0]

    spans.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        if remat:
            y = torch.utils.checkpoint.checkpoint(apply, x, use_reentrant=False)
        else:
            y = apply(x)
        y.sum().backward()
    got = spans.counters()
    spans.reset_counters()
    times = 2 if remat else 1
    assert got == {"moe/assigned": float(times * keep.numel()),
                   "moe/dropped": float(times * int((~keep).sum()))}


def test_moe_counting_adds_no_operation(monkeypatch):
    """While recording, ``moe_apply`` runs the same operations whether it
    counts or not: the dropped assignments are summed after the window."""
    cfg = tconfigs.get_reduced("deepseek-moe-16b").with_(moe_capacity_factor=0.5)
    gen = torch.Generator().manual_seed(3)
    params = _moe_params(cfg, gen)
    x = torch.randn(2, 16, cfg.d_model, generator=gen)

    def ops():
        spans.reset_counters()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            moe.moe_apply(params, x, cfg)
        return [e.name for e in prof.events() if e.name.startswith("aten::")]

    counted = ops()
    assert spans.counters()["moe/dropped"] > 0
    monkeypatch.setattr(moe, "recording", lambda: False)   # no counting
    assert ops() == counted
    spans.reset_counters()


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_profile_train_span_table():
    """``launch.profile_train.span_table`` on a hand-built trace: thread 2
    launches under thread 1's ``train/backward``, a bucket span's kernel
    counts in both, idle time goes to the innermost span open on the
    stepping thread when it began, a kernel launched after the last span
    to the row outside every span."""
    from repro_torch.launch.profile_train import OUTSIDE, span_table

    trace = [
        _ev("train/forward", "user_annotation", 0, 20),
        _ev("train/backward", "user_annotation", 20, 40),
        _ev("covap_bucket_0/phase_0", "user_annotation", 41, 4, tid=2),
        _ev("train/optimizer", "user_annotation", 60, 20),
        _ev("cudaLaunchKernel", "cuda_runtime", 2, 1, corr=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 25, 1, tid=2, corr=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 42, 1, tid=2, corr=3),
        _ev("cudaLaunchKernel", "cuda_runtime", 61, 1, corr=4),
        _ev("gemm", "kernel", 5, 5, tid=7, corr=1),
        _ev("gemm", "kernel", 30, 10, tid=7, corr=2),
        _ev("ef_update_kernel", "kernel", 45, 5, tid=7, corr=3),
        _ev("elementwise", "kernel", 70, 2, tid=7, corr=4),
        _ev("cudaLaunchKernel", "cuda_runtime", 90, 1, corr=5),
        _ev("fill", "kernel", 91, 3, tid=7, corr=5),
    ]
    rows = {name: vals for name, *vals in span_table(trace, 1)}
    want = {"covap_bucket_*": (0.005, 0.004, 0.0),
            "train/backward": (0.015, 0.040, 0.025),
            "train/forward": (0.005, 0.020, 0.025),
            "train/optimizer": (0.002, 0.020, 0.008),
            OUTSIDE: (0.003, 0.0, 0.0)}
    assert rows.keys() == want.keys()
    for name, vals in want.items():
        assert rows[name] == pytest.approx(vals), name
