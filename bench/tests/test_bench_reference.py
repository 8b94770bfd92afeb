"""The benchmark's plain reference against ``repro_torch`` on the CPU, at
small sizes: the batches, the decoder's and the MoE block's loss and
gradients, the bucket plan, and whole first steps through ``Trainer.step``
(exchange, error feedback and AdamW) on one and on two gloo workers.  The
tests import the port; the reference does not."""
from __future__ import annotations

import ast
import json
import multiprocessing as mp
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_cells import small_cell

from bench import check, harness, weights
from bench.reference import covap, model as ref_model
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


@pytest.mark.parametrize("config", ["gpt2-paper", "deepseek-moe-16b-2L"])
def test_loss_and_gradients_equal_the_port(config, small):
    from repro_torch.models import build_model

    cell = small(config)
    a = ref_model.Arch.from_config(cell.conf)
    shapes = ref_model.param_shapes(a)
    seed = 9
    params = weights.make_leaves(shapes, seed, "cpu")
    port = build_model(_port_cfg(cell.conf), device="cpu")
    leaves = port.named_leaves()
    assert [p for p, _ in leaves] == list(shapes)
    for i, (path, p) in enumerate(leaves):
        weights.fill_leaf(p.data, seed, i, path)
    tokens, labels = (torch.from_numpy(x) for x in Batches(seed, a.vocab_size, 32, 4, 1).batch(0, 0))
    total, metrics = port.loss_fn({"tokens": tokens, "labels": labels})
    total.backward()
    for p in params.values():
        p.requires_grad_(True)
    ref_total, xent, aux, _ = ref_model.loss(params, tokens, labels, a)
    ref_total.backward()
    assert float(total.detach()) == pytest.approx(float(ref_total.detach()), rel=1e-5)
    assert float(metrics["aux_loss"]) == pytest.approx(float(aux.detach()), rel=1e-5, abs=1e-7)
    for (path, p), r in zip(leaves, params.values()):
        torch.testing.assert_close(p.grad, r.grad, rtol=1e-4, atol=1e-6, msg=path)


@pytest.mark.parametrize("config", ["gpt2-paper", "deepseek-moe-16b-2L"])
@pytest.mark.parametrize("full", [False, True])
def test_bucket_plan_equals_the_port(config, full, small):
    from repro_torch.core import build_plan
    from repro_torch.models import build_model

    cell = harness.load_cell(small(config).name) if full else small(config)
    shapes = ref_model.param_shapes(ref_model.Arch.from_config(cell.conf))
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


@pytest.mark.parametrize("config", ["gpt2-paper", "deepseek-moe-16b-2L"])
def test_first_steps_equal_the_port(config, small, port):
    cell = small(config)
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
