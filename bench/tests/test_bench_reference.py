"""The benchmark's plain reference against ``repro_torch`` on the CPU, at
small sizes: the batches, each configuration's loss and gradients by its
own reference module, the bucket plan, and whole first steps through
``Trainer.step`` (exchange, error feedback and AdamW) on one and on two
gloo workers, over ``BENCHMARK.json``'s configurations and cells.  The
tests import the port; the reference does not."""
from __future__ import annotations

import ast
import json
import multiprocessing as mp
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_cells import CONFIGS, WORKLOADS, small_cell

from bench import check, harness, reference, weights
from bench.reference import covap
from bench.reference import train as ref_train
from bench.reference.data import Batches

BENCH = Path(__file__).resolve().parents[1]
PORT_FREE = ("reference", "yardstick", "metrics")


def _port_cfg(conf: dict):
    import dataclasses

    from repro_torch.configs.base import ArchConfig

    names = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in conf.items() if k in names})


@pytest.mark.parametrize("sub", PORT_FREE)
def test_yardstick_imports_nothing_of_the_system(sub):
    for path in sorted((BENCH / sub).rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            bad = [n for n in names if n.split(".")[0] in ("repro_torch", "repro", "jax")]
            assert not bad, f"{path.relative_to(BENCH)} imports {bad}"


@pytest.mark.parametrize("workers", [1, 3])
def test_batches_equal_the_loader(workers):
    from repro_torch.data import DataConfig, make_loader

    seed = 2**31 + 17
    ref = Batches(seed, 300, 16, 2, workers)
    for w in range(workers):
        loader = make_loader(DataConfig(vocab_size=300, seq_len=16, global_batch=2 * workers,
                                        seed=seed), workers, w, device="cpu")
        for step in (0, 5):
            port = loader.make_numpy(step)
            tokens, labels = ref.batch(step, w)
            np.testing.assert_array_equal(tokens, port["tokens"])
            np.testing.assert_array_equal(labels, port["labels"])


@pytest.mark.parametrize("config", CONFIGS)
def test_loss_and_gradients_equal_the_port(config, small):
    from repro_torch.models import build_model

    cell = small(config)
    ref = reference.of(cell.conf)
    rule = getattr(ref, "std_of", None)
    a = ref.Arch.from_config(cell.conf)
    shapes = ref.param_shapes(a)
    seed = 9
    params = weights.make_leaves(shapes, seed, "cpu", rule)
    port = build_model(_port_cfg(cell.conf), device="cpu")
    leaves = port.named_leaves()
    assert [p for p, _ in leaves] == list(shapes)
    for i, (path, p) in enumerate(leaves):
        weights.fill_leaf(p.data, seed, i, path, rule)
    vocab = cell.conf["vocab_size"]
    tokens, labels = (torch.from_numpy(x) for x in Batches(seed, vocab, 32, 4, 1).batch(0, 0))
    total, metrics = port.loss_fn({"tokens": tokens, "labels": labels})
    total.backward()
    for p in params.values():
        p.requires_grad_(True)
    ref_total, xent, aux, _ = ref.loss(params, tokens, labels, a, torch.matmul)
    ref_total.backward()
    assert float(total.detach()) == pytest.approx(float(ref_total.detach()), rel=1e-5)
    assert float(metrics["aux_loss"]) == pytest.approx(float(aux.detach()), rel=1e-5, abs=1e-7)
    for (path, p), r in zip(leaves, params.values()):
        torch.testing.assert_close(p.grad, r.grad, rtol=1e-4, atol=1e-6, msg=path)


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("full", [False, True])
def test_bucket_plan_equals_the_port(name, full, small):
    from repro_torch.core import build_plan
    from repro_torch.models import build_model

    cell = harness.load_cell(name) if full else small(cell=name)
    ref = reference.of(cell.conf)
    shapes = ref.param_shapes(ref.Arch.from_config(cell.conf))
    model = build_model(_port_cfg(cell.conf), device="meta")
    t = cell.traffic
    plan = build_plan(model.named_leaves(), bucket_bytes=t["bucket_bytes"],
                      max_buckets=t["max_buckets"], interval=t["interval"])
    ref = covap.plan_buckets(list(shapes.values()), bucket_bytes=t["bucket_bytes"],
                             max_buckets=t["max_buckets"], interval=t["interval"])
    port = [[(s.leaf_idx, s.row_lo, s.row_hi, s.sub_axis, s.sub_lo, s.sub_hi)
             for s in b.segments] for b in plan.buckets]
    mine = [[(s.leaf, s.row_lo, s.row_hi, s.axis, s.lo, s.hi) for s in b] for b in ref]
    assert mine == port
    assert len(mine) > 1


@pytest.mark.parametrize("name", WORKLOADS)
def test_first_steps_equal_the_port(name, small, port):
    cell = small(cell=name)
    out = harness.run_rank(cell, seed=2**31 + 5, seconds=0.0, trace=False, rank=0,
                           world=1, port=port, device="cpu", t_start=0.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1


def _two_workers(rank, port, path, config):
    cell = small_cell(config)
    out = harness.run_rank(cell, seed=77, seconds=0.0, trace=False, rank=rank, world=2,
                           port=port, device="cpu", t_start=0.0)
    if rank == 0:
        Path(path).write_text(json.dumps(out))


def test_two_workers_equal_the_reference(tmp_path, port):
    path = tmp_path / "out.json"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_two_workers, args=(r, port, str(path), "gpt2-paper"))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    assert [p.exitcode for p in procs] == [0, 0]
    out = json.loads(path.read_text())
    assert out["correct"], out["checks"]


def test_reference_steps_follow_the_rule_of_covap(small):
    """With every bucket exchanged every step (I = 1) the optimizer's first
    gradient is the raw one; at I = 4 three buckets in four send nothing."""
    cell = small("gpt2-paper")
    cell.traffic.update(interval=1)
    ref = ref_train.run(cell.conf, cell.traffic, seed=3, workers=1, device="cpu", steps=1)
    assert ref["grad"] == pytest.approx(ref["grad_raw"], rel=1e-6)
    cell.traffic.update(interval=4)
    ref = ref_train.run(cell.conf, cell.traffic, seed=3, workers=1, device="cpu", steps=1)
    zero = [g == 0.0 for g in ref["grad"]]
    assert any(zero) and not all(zero)
    # over the whole cycle every bucket is sent once, so no leaf reads zero
    ref = ref_train.run(cell.conf, cell.traffic, seed=3, workers=1, device="cpu")
    assert len(ref["loss"]) == 4
    assert all(g > 0.0 for g in ref["grad"])
    assert check.NAMES == ("loss_gap", "grad_gap", "grad_diff", "change_gap")


@pytest.mark.parametrize("key, value", [("compressor", "powersgd"), ("compressor", "none"),
                                        ("sync", "hier")])
def test_the_reference_refuses_a_mix_it_does_not_model(key, value, small):
    cell = small("gpt2-paper")
    cell.traffic[key] = value
    with pytest.raises(ValueError, match=key):
        ref_train.run(cell.conf, cell.traffic, seed=3, workers=1, device="cpu")


# the small cells' reference losses over the first cycle (seed 2**31 + 11),
# as computed before the reference was looked up by configuration: the
# weights and the reference's first cycle have not moved
PINNED_LOSS = {
    "gpt2-paper": [6.473791122436523, 6.485506057739258, 6.325545310974121,
                   6.52878475189209],
    "deepseek-moe-16b-2L": [6.338286399841309, 6.419840335845947, 6.286617755889893,
                            6.541128158569336],
}


@pytest.mark.parametrize("config", sorted(PINNED_LOSS))
def test_the_reference_reads_what_it_read_before(config, small):
    cell = small(config)
    ref = ref_train.run(cell.conf, cell.traffic, seed=2**31 + 11, workers=1, device="cpu")
    assert ref["loss"] == pytest.approx(PINNED_LOSS[config], rel=1e-5)


MARKER = 1234.5


def _stub(calls: dict):
    """The decoder's module under a new name, each function recording the
    module that called it; its ``step_flops`` returns :data:`MARKER`, its
    ``std_of`` gives the embedding its own start."""
    model = reference.of({})

    def traced(fn):
        def call(*args, **kwargs):
            calls.setdefault(fn.__name__, set()).add(sys._getframe(1).f_globals["__name__"])
            return fn(*args, **kwargs)
        call.__name__ = fn.__name__
        return call

    @traced
    def step_flops(conf, *, rows, seq_len):
        return MARKER

    @traced
    def std_of(path, shape):
        return 0.05 if path == "embed.table" else None

    stub = types.ModuleType(f"{reference.__name__}.stub_decoder")
    stub.Arch = model.Arch
    stub.param_shapes, stub.loss = traced(model.param_shapes), traced(model.loss)
    stub.step_flops, stub.std_of = step_flops, std_of
    return stub


def test_a_configuration_brings_its_own_reference(small, port, monkeypatch):
    """A configuration naming a reference module is served by it: the
    program's leaf check, the bucket plan, the trace's FLOPs and the
    reference's first cycle all reach the module, and its ``std_of`` sets
    the weights of both sides."""
    calls: dict = {}
    stub = _stub(calls)
    monkeypatch.setitem(sys.modules, stub.__name__, stub)
    cell = small(CONFIGS[0])
    cell.conf["reference"] = "stub_decoder"
    assert reference.of(cell.conf) is stub
    seen = {}
    monkeypatch.setattr(harness, "reader", lambda name: lambda view: seen.update(view.context))
    out = harness.run_rank(cell, seed=2**31 + 19, seconds=0.0, trace=True, rank=0, world=1,
                           port=port, device="cpu", t_start=0.0)
    assert out["correct"], out["checks"]
    assert calls["param_shapes"] >= {"bench.harness", "bench.yardstick.ef_bytes",
                                      "bench.reference.train"}
    assert calls["loss"] == {"bench.reference.train"}
    assert calls["step_flops"] == {"bench.harness"}
    assert calls["std_of"] == {"bench.weights"}
    assert seen["flops_per_step"] == MARKER
    assert seen["conf"] is cell.conf and seen["traffic"] is cell.traffic
    assert (seen["rows"], seen["seq_len"]) == (4, 32)
    assert weights.std_of("embed.table", (300, 64), stub.std_of) == 0.05
    assert weights.std_of("head.w", (64, 384), stub.std_of) == weights.std_of("head.w", (64, 384))


@pytest.mark.parametrize("name, error", [("no_such_family", "no_such_family.py is missing"),
                                         ("../model", "no module name"),
                                         (3, "no module name")])
def test_an_unknown_reference_is_refused(name, error):
    with pytest.raises(LookupError, match=error):
        reference.of({"reference": name})


def test_only_the_lookup_names_the_decoder_module():
    """Outside ``bench/reference/`` every caller reaches the decoder through
    ``reference.of``: nothing else names its module."""
    names = re.compile(r"reference[^\n]model|reference[ ]import[ ]model")
    hits = []
    for path in sorted(BENCH.rglob("*")):
        rel = path.relative_to(BENCH)
        if (not path.is_file() or rel.parts[0] == "reference" or "__pycache__" in rel.parts
                or path.suffix not in (".py", ".md", ".json")):
            continue
        hits += [f"{rel}:{i}" for i, line in enumerate(path.read_text().splitlines(), 1)
                 if names.search(line)]
    assert not hits, hits
