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

import _torch_reference_runs as ref_runs
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


def _start(cmd, env=ENV):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)


def _start_torchrun(nproc, args):
    """The CLI under ``torch.distributed.run`` on ``nproc`` gloo ranks,
    started and not waited for."""
    return _start([sys.executable, "-m", "torch.distributed.run", "--standalone",
                   f"--nproc-per-node={nproc}", "-m", "repro_torch.launch.train", *args])


def _finish(p, timeout=300):
    """Wait for a started subprocess; -> its stdout, once it exited 0."""
    try:
        stdout, stderr = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, stdout[-3000:] + stderr[-3000:]
    return stdout


def _torchrun(nproc, args, timeout=300):
    return _finish(_start_torchrun(nproc, args), timeout)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """-> (stdout, history dict) of the CLI on two gloo ranks, and each
    rank's ``api.fit(group=)`` losses on the same arguments."""
    tmp = tmp_path_factory.mktemp("launch")
    hist, ref = tmp / "history.json", tmp / "ref.json"
    # the CLI, the reference's CLI (for its history keys) and the fit
    # workers run at once
    cli = _start_torchrun(2, [*CLI, "--history-out", str(hist)])
    ref_cli = _start(
        [sys.executable, "-m", "repro.launch.train", "--arch", "gpt2-paper", "--reduced",
         "--steps", "2", "--seq-len", "16", "--global-batch", "4", "--interval", "2",
         "--log-every", "1", "--history-out", str(ref)], ref_runs.one_thread_env(ENV))
    try:
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
        out = _finish(cli)
        _finish(ref_cli)
    finally:
        for p in (cli, ref_cli):
            if p.poll() is None:
                p.kill()
                p.wait()
    fits = [dict(np.load(tmp / f"fit{r}.npz")) for r in range(2)]
    return out, json.loads(hist.read_text()), fits, json.loads(ref.read_text())


def test_two_process_cli_equals_fit_with_a_group(two_ranks):
    out, hist, fits, _ = two_ranks
    assert "[launch] 2 rank(s), 1 pod(s) x 2, backend gloo" in out
    assert f"[done] step {STEPS} ({STEPS} committed)" in out
    assert out.count("[done]") == 1                       # rank 0 prints alone
    losses = np.array([h["loss"] for h in hist["history"]])
    assert [h["step"] for h in hist["history"]] == list(range(1, STEPS + 1))
    for fit in fits:
        np.testing.assert_array_equal(fit["steps"], np.arange(1, STEPS + 1))
        np.testing.assert_array_equal(losses, fit["losses"])


def test_history_out_has_the_reference_keys(two_ranks):
    """Against ``python -m repro.launch.train --history-out`` (run in
    ``two_ranks``, beside the port's CLI)."""
    _, hist, _, want = two_ranks
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
    runs, procs = {}, {}
    try:
        for name, extra in (("flat", []), ("pods", ["--pods", "2"])):
            procs[name] = _start_torchrun(4, [*CLI, "--global-batch", "8", *extra,
                                              "--history-out", str(tmp_path / f"{name}.json")])
        for name, p in procs.items():
            out = _finish(p)
            assert "[pods]" not in out
            runs[name] = [h["loss"] for h in
                          json.loads((tmp_path / f"{name}.json").read_text())["history"]]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
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


# api.fit's arguments in test_fit_and_cli_commit_the_steps_asked_for
GUARDED_FIT = dict(reduced=True, interval=4, steps=8, seq_len=16, global_batch=4,
                   guards=True, faults="grad_nan@3")


@pytest.fixture(scope="module", autouse=True)
def reference_fit():
    """The reference's ``api.fit(**GUARDED_FIT)``, started in a process of
    its own when the module starts: a future of its step and resilience
    summary."""
    calls = {"fit": (ref_runs.api_fit, ("gpt2-paper", GUARDED_FIT))}
    with ref_runs.reference_pool(calls, 1) as futures:
        yield futures["fit"]


def test_fit_and_cli_commit_the_steps_asked_for(capsys, reference_fit):
    """A skipped step is replayed, so 8 steps are committed; the reference's
    ``api.fit`` counts step executions and returns at step 3."""
    import repro_torch.api as api

    got = api.fit("gpt2-paper", device="cpu", **GUARDED_FIT)
    assert got.state["step"] == 8
    assert got.resilience["actions_by_rung"] == {"skip_step": 1}
    cli_main(GUARDED)
    out = capsys.readouterr().out
    ref = reference_fit.result(timeout=900)
    assert ref["step"] == 3                       # pinned: the reference's short run
    assert ref["resilience"]["actions_by_rung"] == {"skip_step": 1}
    assert "[done] step 8 (8 committed)" in out
    assert "{'skip_step': 1}" in out
