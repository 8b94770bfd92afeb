"""The port's multi-process launch: the CLI under ``torch.distributed.run``
on gloo, the process groups of ``launch.mesh``, ``--history-out``, and the
committed-step count of ``api.fit`` and the CLI.

* two gloo processes of the CLI (``--standalone``, no fixed port) train the
  same losses as ``api.fit(group=)`` on the same arguments, bit for bit;
* ``--history-out`` writes the reference CLI's keys;
* ``--pods 2 --pod-interval 2`` on four ranks trains and reports the plan's
  bytes per link; ``--pods 2`` at the default ``--pod-interval 1`` equals
  the flat four-rank run;
* ``pod_rank_lists`` cuts the world as the reference's row-major
  ``("pod", "data")`` mesh does, and raises on a world that does not split;
* ``api.fit`` and the CLI with ``grad_nan@3`` commit the 8 steps asked for;
  the reference's ``api.fit`` returns at step 3 (pinned).
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from _torch_dist_worker import fit_worker

from repro_torch.launch import mesh
from repro_torch.launch.train import main as cli_main

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ROOT = os.path.dirname(SRC)
ENV = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
           OMP_NUM_THREADS="1")
STEPS = 4
CLI = ["--reduced", "--steps", str(STEPS), "--seq-len", "16", "--global-batch", "4",
       "--device", "cpu", "--interval", "2", "--log-every", "1"]
# api.fit with the CLI's defaults (bucket size, optimizer, lr)
FIT = dict(arch="gpt2-paper", reduced=True, interval=2, steps=STEPS, seq_len=16,
           global_batch=4, bucket_bytes=25 * 1024 * 1024, max_buckets=128,
           optimizer="adam", lr=1.5e-4, log_every=1)
GUARDED = ["--reduced", "--steps", "8", "--seq-len", "16", "--global-batch", "4",
           "--device", "cpu", "--interval", "4", "--guards", "--inject-faults",
           "grad_nan@3"]


def _torchrun(nproc, args, timeout=300):
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, env=ENV, timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """-> (stdout, history dict) of the CLI on two gloo ranks, and each
    rank's ``api.fit(group=)`` losses on the same arguments."""
    tmp = tmp_path_factory.mktemp("launch")
    hist = tmp / "history.json"
    out = _torchrun(2, [*CLI, "--history-out", str(hist)])
    ctx = mp.start_processes(fit_worker, args=(2, str(tmp / "rendezvous"),
                                               str(tmp / "fit"), FIT),
                             nprocs=2, join=False, start_method="spawn")
    for _ in range(300):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        raise AssertionError("gloo workers did not finish within 300 s")
    fits = [dict(np.load(tmp / f"fit{r}.npz")) for r in range(2)]
    return out, json.loads(hist.read_text()), fits


def test_two_process_cli_equals_fit_with_a_group(two_ranks):
    out, hist, fits = two_ranks
    assert "[launch] 2 rank(s), 1 pod(s) x 2, backend gloo" in out
    assert f"[done] step {STEPS} ({STEPS} committed)" in out
    assert out.count("[done]") == 1                       # rank 0 prints alone
    losses = np.array([h["loss"] for h in hist["history"]])
    assert [h["step"] for h in hist["history"]] == list(range(1, STEPS + 1))
    for fit in fits:
        np.testing.assert_array_equal(fit["steps"], np.arange(1, STEPS + 1))
        np.testing.assert_array_equal(losses, fit["losses"])


def test_history_out_has_the_reference_keys(two_ranks, tmp_path):
    _, hist, _ = two_ranks
    ref = tmp_path / "ref.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", "--arch", "gpt2-paper", "--reduced",
         "--steps", "2", "--seq-len", "16", "--global-batch", "4", "--interval", "2",
         "--log-every", "1", "--history-out", str(ref)],
        capture_output=True, text=True, env=ENV, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(ref.read_text())
    assert sorted(hist) == sorted(want) == ["config", "history", "interval"]
    assert hist["interval"] == want["interval"] == 2
    assert sorted(hist["history"][0]) == sorted(want["history"][0])
    shared = set(hist["config"]) & set(want["config"])
    assert {"arch", "reduced", "steps", "seq_len", "global_batch", "interval",
            "history_out"} <= shared
    for k in shared - {"history_out", "steps"}:
        assert hist["config"][k] == want["config"][k], k


def test_pods_on_four_ranks_report_the_plan_bytes_per_link():
    from repro_torch.configs import get_reduced
    from repro_torch.core import build_plan, get_compressor
    from repro_torch.models import param_shapes
    from repro_torch.train import hierarchical_schedules

    out = _torchrun(4, [*CLI, "--global-batch", "8", "--pods", "2", "--pod-interval",
                        "2", "--sync", "sharded"])
    assert "[launch] 4 rank(s), 2 pod(s) x 2, backend gloo" in out
    assert f"[done] step {STEPS} ({STEPS} committed)" in out
    m = re.search(r"\[pods\] 2 pods x 2, pod interval 2, 2 phases; mean bytes/step "
                  r"per worker: ici ([0-9.]+) MB, dcn ([0-9.]+) MB", out)
    assert m, out
    leaves = [(k, torch.empty(s, device="meta"))
              for k, s in param_shapes(get_reduced("gpt2-paper")).items()]
    plan = build_plan(leaves, interval=2)
    scheds = hierarchical_schedules(get_compressor("covap", interval=2, sync="sharded"),
                                    plan, pod_interval=2, sync="sharded",
                                    intra_world=2, n_pods=2)
    for link, got in zip(("ici", "dcn"), m.groups()):
        want = sum(s.exposed_bytes_by_link().get(link, 0) for s in scheds) / len(scheds)
        assert got == f"{want / 1e6:.3f}"
        assert want > 0


def test_pods_at_pod_interval_one_equal_the_flat_world(tmp_path):
    """Without a pod interval the pods are no level of their own: every
    step syncs over the whole world, as the reference's ``pod_interval=1``
    on a ``("pod", "data")`` mesh does, so the losses equal the flat
    four-rank run's bit for bit."""
    runs = {}
    for name, extra in (("flat", []), ("pods", ["--pods", "2"])):
        hist = tmp_path / f"{name}.json"
        out = _torchrun(4, [*CLI, "--global-batch", "8", *extra,
                            "--history-out", str(hist)])
        assert "[pods]" not in out
        runs[name] = [h["loss"] for h in json.loads(hist.read_text())["history"]]
    assert "[launch] 4 rank(s), 2 pod(s) x 2, backend gloo" in out
    assert len(runs["flat"]) == STEPS
    assert runs["pods"] == runs["flat"]


def test_group_layout_is_the_reference_mesh_and_refuses_an_uneven_world():
    grid = np.arange(8).reshape(2, 4)          # row-major ("pod", "data")
    intra, cross = mesh.pod_rank_lists(8, 2)
    assert intra == grid.tolist() and cross == grid.T.tolist()
    assert mesh.pod_rank_lists(4, 1) == ([[0, 1, 2, 3]], [[0], [1], [2], [3]])
    for world, pods in ((6, 4), (4, 0), (3, 2)):
        with pytest.raises(ValueError, match="does not split"):
            mesh.pod_rank_lists(world, pods)
    with pytest.raises(RuntimeError, match="initialised"):
        mesh.build_groups(2)


def test_launch_takes_the_card_unless_asked_for_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the refusal needs none")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.launched()
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.init_from_env("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        cli_main(["--reduced", "--steps", "1"])
    monkeypatch.delenv("RANK")
    with pytest.raises(SystemExit, match="torch.distributed.run"):
        cli_main(["--reduced", "--steps", "1", "--device", "cpu", "--pods", "2"])


def test_fit_and_cli_commit_the_steps_asked_for(capsys):
    """A skipped step is replayed, so 8 steps are committed; the reference's
    ``api.fit`` counts step executions and returns at step 3."""
    import repro.api as rapi
    import repro_torch.api as api

    kw = dict(reduced=True, interval=4, steps=8, seq_len=16, global_batch=4,
              guards=True, faults="grad_nan@3")
    got = api.fit("gpt2-paper", device="cpu", **kw)
    assert got.state["step"] == 8
    assert got.resilience["actions_by_rung"] == {"skip_step": 1}
    ref = rapi.fit("gpt2-paper", **kw)
    assert ref.state["step"] == 3                 # pinned: the reference's short run
    assert ref.resilience["actions_by_rung"] == {"skip_step": 1}
    cli_main(GUARDED)
    out = capsys.readouterr().out
    assert "[done] step 8 (8 committed)" in out
    assert "{'skip_step': 1}" in out
