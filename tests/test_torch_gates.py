"""The port's overlap and sharded gates (``repro_torch.launch.overlap_gate``,
``sharded_gate``) and the trace analysis they read, on profiled steps of
the gates' REDUCED gpt2-paper COVAP (I = 4) trainer in one 2-rank gloo
spawn for the whole file:

* the bytes a profiled step's collectives inject (``c10d::*`` events
  read with ``count_collectives``'s spans) equal that phase's plan
  exactly, once ``min_bytes`` drops the scalar metric reductions;
* the fused step is interleaved and the post step is not (the negative
  control); the sharded step is placed and the all-reduce step is not;
* an arena step's extra data movement over the legacy step is its slot
  writes alone (the reference's ``tests/test_arena.py`` claim of strictly
  fewer ops does not carry over: the port's legacy sync has no
  concatenate/split chain to remove);
* the sharded gate's exposed ratio equals the reference's at W = 8 on the
  same plan (0.5, ``BENCH_5.json``);
* both gates' CLIs on 2 gloo ranks."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest
import torch.multiprocessing as mp

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.models import build_model as r_build_model
from repro.train.trainer import TrainConfig as RTrainConfig
from repro.train.trainer import make_compressor as r_make_compressor

from _torch_dist_worker import gates_worker
from repro_torch.launch import overlap_gate, sharded_gate

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
WORLD = 2
# name -> (overlap_gate.build_trainer kwargs, the profiled phase)
STEPS = {
    "fused": ({}, 0),
    "fused-phase-2": ({}, 2),
    "post": ({"overlap": "post"}, 1),
    "sharded": ({"sync": "sharded"}, 0),
    "legacy": ({"overlap": "post"}, 0),
    "arena": ({"overlap": "post", "arena": True}, 0),
}
# the plan's smallest call is a 256-byte shard; the step's metric average
# and the sharded grad-norm sum are 4-12 bytes
MIN_BYTES = 64


def _start_gates():
    """Both gates' CLIs on 2 gloo ranks, started at once."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return {m: subprocess.Popen([sys.executable, "-m", f"repro_torch.launch.{m}",
                                 "--device", "cpu", "--world", str(WORLD)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, env=env, cwd=ROOT)
            for m in ("overlap_gate", "sharded_gate")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gates' CLIs and, meanwhile, the profiled steps of ``STEPS`` on
    one spawn: ``{"steps": [rank 0, rank 1], "gates": {module: (return
    code, stdout, stderr)}}``."""
    tmp = tmp_path_factory.mktemp("gates")
    procs = _start_gates()
    try:
        ctx = mp.start_processes(gates_worker, args=(WORLD, str(tmp / "rdv"),
                                                     str(tmp / "out"), STEPS),
                                 nprocs=WORLD, join=False, start_method="spawn")
        for _ in range(300):
            if ctx.join(timeout=1):
                break
        else:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("gloo workers did not finish within 300 s")
        assert not any(p.is_alive() for p in ctx.processes)
        gates = {}
        for m, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            gates[m] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r in range(WORLD):
        with open(tmp / f"out{r}.json") as f:
            out.append(json.load(f))
    return {"steps": out, "gates": gates}


@pytest.fixture(scope="module")
def steps(runs):
    return runs["steps"]


@pytest.mark.parametrize("name", sorted(STEPS))
def test_trace_bytes_equal_the_phase_plan(steps, name):
    for rank in steps:
        s = rank[name]
        plan = s["plan_by_link"]["ici"]
        assert plan == s["plan_bytes_per_worker"] > 0
        assert s["counted"] == s["plan_by_link"]
        assert s["bytes_per_worker"] == plan
        assert s["bytes_by_link"] == {"ici": plan, "dcn": 0.0}
        # the metric average is in no plan: counted apart, and filtered
        assert 0 < s["unplanned"]["ici"] < MIN_BYTES


def test_fused_step_is_interleaved_and_post_is_not(steps):
    for rank in steps:
        for name in ("fused", "fused-phase-2"):
            r = rank[name]["interleave"]
            assert r["num_collectives"] > 0 and r["before_final_grad"] >= 1, name
            assert r["independent"] == r["before_final_grad"]
            assert r["first_collective_pos"] < r["last_grad_pos"]
            assert (r["device_early"], r["device_buckets"]) == (-1, -1)
            # the host spans of the hooks follow their firing order
            assert rank[name]["spans"] == rank[name]["fired"]
        post = rank["post"]["interleave"]
        assert post["num_collectives"] > 0 and post["num_grad_ops"] > 0
        assert post["before_final_grad"] == 0 and post["independent"] == 0
        assert rank["post"]["spans"] == []


def test_sharded_step_is_placed_and_allreduce_is_not(steps):
    for rank in steps:
        r = rank["sharded"]["placement"]
        assert r["num_reduce_scatter"] > 0 and r["num_all_gather"] > 0
        assert r["rs_before_final_grad"] >= 1 and r["ag_before_first_rs"] >= 1
        assert r["first_ag_pos"] < r["first_rs_pos"] < r["last_grad_pos"]
        # the head gather was issued for every bucket before the forward
        issued = [b for kind, b in rank["sharded"]["gather_events"] if kind == "issue"]
        assert len(issued) >= r["num_all_gather"]
        ar = rank["fused"]["placement"]
        assert ar["num_reduce_scatter"] == 0 and ar["num_all_gather"] == 0
        assert not (ar["rs_before_final_grad"] >= 1 and ar["ag_before_first_rs"] >= 1)


def test_placed_property_follows_the_report(steps):
    from repro_torch.launch.hlo_analysis import ShardedPlacementReport

    for rank in steps:
        assert ShardedPlacementReport(**rank["sharded"]["placement"]).placed
        assert not ShardedPlacementReport(**rank["fused"]["placement"]).placed


def test_arena_step_adds_only_its_slot_writes(steps):
    """The reference's arena claim (``tests/test_arena.py``: strictly fewer
    data-movement ops with the arena on) is about its legacy path's
    concatenate/split chains.  The port's legacy sync has none: it
    all-reduces each selected segment where it lies, so both steps
    concatenate the same (the model's own ``aten::cat``) and the arena step
    issues more copies, exactly one a selected segment: the CPU stand-in of
    ``pack_ef_cast`` writing the segment's wire values into its slot (on
    the card the kernel writes the slot itself)."""
    for rank in steps:
        off, on = rank["legacy"]["data_movement"], rank["arena"]["data_movement"]
        assert on["aten::cat"] == off["aten::cat"]
        assert on["aten::copy_"] - off["aten::copy_"] == rank["arena"]["selected_segments"]
        assert on["total"] - off["total"] == rank["arena"]["selected_segments"] > 0


def _reference_exposed_ratio(world):
    """``repro.launch.sharded_gate.exposed_ratio`` on the reference gate's
    plan, planned at ``world`` without a mesh."""
    rcfg = rconfigs.get_reduced("gpt2-paper").with_(vocab_size=256)
    tc = RTrainConfig(compressor="covap", interval=4, bucket_bytes=1 << 14,
                      max_buckets=32, log_every=10 ** 9, overlap="fused", sync="sharded")
    shapes = jax.eval_shape(r_build_model(rcfg).init, jax.random.PRNGKey(0))
    plan = r_build_plan(shapes, bucket_bytes=tc.bucket_bytes, max_buckets=tc.max_buckets,
                        interval=tc.interval)
    sharded = r_make_compressor(tc)
    dense = r_make_compressor(dataclasses.replace(tc, sync="allreduce"))
    n = sharded.num_phases(tc.interval)
    exposed = sum(sharded.plan_phase(plan, p, world=world).exposed_wire_bytes(world)
                  for p in range(n))
    ar = sum(dense.plan_phase(plan, p, world=world).exposed_wire_bytes(world)
             for p in range(n))
    return exposed / ar


@pytest.mark.parametrize("world", [2, 8])
def test_exposed_ratio_equals_reference(world):
    tr, _, _ = sharded_gate.build_trainer(device="cpu")
    got = sharded_gate.exposed_ratio(tr, world=world)
    assert got == pytest.approx(_reference_exposed_ratio(world), rel=1e-12, abs=0)
    if world == 8:
        assert f"{got:.3f}" == "0.500"           # BENCH_5.json's sharded_exposed_ratio


def _gate(runs, module):
    rc, stdout, stderr = runs["gates"][module]
    assert rc == 0, stdout + stderr[-3000:]
    line = stdout.strip().splitlines()[-1]
    return line, dict(p.split("=") for p in line.split()[1:])


def test_overlap_gate_cli_on_two_gloo_ranks(runs):
    line, kv = _gate(runs, "overlap_gate")
    assert line.startswith("OVERLAP ")
    assert kv["interleaved"] == "True" and int(kv["before_final_grad"]) >= 1


def test_sharded_gate_cli_on_two_gloo_ranks(runs):
    line, kv = _gate(runs, "sharded_gate")
    assert line.startswith("SHARDED ")
    assert kv["placed"] == "True" and float(kv["exposed_ratio"]) <= 0.6


def test_gates_refuse_a_missing_card():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        overlap_gate.build_trainer(device="cuda")
