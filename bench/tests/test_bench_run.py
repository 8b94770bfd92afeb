"""The benchmark's run rules and its comparison's power, on the CPU: a run
with a planted fault, or with the float8 control in the system's place,
comes out not correct; the command refuses to run without cards and
prints no result; no run loads JAX, Flax or the JAX package.  The control
at the cell's own size runs on the card (``cuda`` marker)."""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_cells import CONFIGS, SMALL_LIMITS, WORKLOADS, small_cell

from bench import check, harness
from bench.faults import FAULTS
from bench.reference import train as ref_train

ROOT = Path(__file__).resolve().parents[2]
RUN = ROOT / "bench" / "run.py"


def _patched(kind):
    return lambda prog: FAULTS[kind](prog)


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered", "residual"])
def test_a_planted_fault_is_not_correct(name, kind, small, port):
    out = harness.run_rank(small(cell=name), seed=2**31 + 3, seconds=0.0, trace=False, rank=0,
                           world=1, port=port, device="cpu", t_start=0.0,
                           patch=_patched(kind))
    assert not out["correct"], out["checks"]


def _worker(rank, port, path, kind):
    patch = _patched(kind) if kind else None
    out = harness.run_rank(small_cell("gpt2-paper"), seed=41, seconds=0.0, trace=False,
                           rank=rank, world=2, port=port, device="cpu", t_start=0.0,
                           patch=patch)
    if rank == 0:
        Path(path).write_text(json.dumps(out))


@pytest.mark.parametrize("kind", ["", "no_exchange"])
def test_the_exchange_left_out_is_not_correct(kind, tmp_path, port):
    path = tmp_path / "out.json"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, port, str(path), kind)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    assert [p.exitcode for p in procs] == [0, 0]
    out = json.loads(path.read_text())
    assert out["correct"] == (kind == ""), out["checks"]


@pytest.mark.parametrize("config", CONFIGS)
def test_the_float8_control_is_not_correct(config, small):
    cell = small(config)
    ref = ref_train.run(cell.conf, cell.traffic, seed=12, workers=1, device="cpu")
    control = ref_train.run(cell.conf, cell.traffic, seed=12, workers=1, device="cpu",
                            mm="fp8")
    found = check.gaps([control], ref)
    assert not check.verdict(found, SMALL_LIMITS), found


def test_the_checks_come_last(small, port):
    out = harness.run_rank(small("gpt2-paper"), seed=5, seconds=0.0, trace=True, rank=0,
                           world=1, port=port, device="cpu", t_start=0.0)
    assert out["correct"]
    assert list(out["checks"]) == list(SMALL_LIMITS)
    assert all(v["limit"] == SMALL_LIMITS[k] for k, v in out["checks"].items())


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_no_card_no_result():
    r = subprocess.run([sys.executable, str(RUN), "--workload", "gpt2-paper.covap.b8",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "needs 1 CUDA device" in r.stderr


def test_a_run_loads_no_jax():
    code = (
        "import sys, runpy\n"
        f"sys.argv = [{str(RUN)!r}, '--workload', 'gpt2-paper.covap.b8', '--seed', '1',"
        " '--seconds', '1']\n"
        "ns = runpy.run_path(sys.argv[0], run_name='bench_run')\n"
        "from bench import harness, calibrate, faults\n"
        "from bench.reference import train\n"
        "import repro_torch.train, repro_torch.models, repro_torch.data\n"
        "print('FOUND', ns['forbidden_modules']())\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=_env(), cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FOUND []" in r.stdout, r.stdout


def test_forbidden_names_are_whole_top_level_names():
    import runpy

    ns = runpy.run_path(str(RUN), run_name="bench_run")
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_x"] = sys
        sys.modules["jaxtyping"] = sys
        assert ns["forbidden_modules"]() == []
        sys.modules["repro.core"] = sys
        sys.modules["jax._src"] = sys
        assert ns["forbidden_modules"]() == ["jax", "repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", WORKLOADS)
def test_the_float8_control_fails_on_the_card(cell_name):
    """The control against the reference at the cell's own size on the card
    (a few seconds each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.load_cell(cell_name)
    ref = ref_train.run(cell.conf, cell.traffic, seed=21, workers=1, device="cuda")
    control = ref_train.run(cell.conf, cell.traffic, seed=21, workers=1, device="cuda",
                            mm="fp8")
    found = check.gaps([control], ref)
    assert not check.verdict(found, cell.limits), found
