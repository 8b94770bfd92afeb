"""The port's trainer on two workers (two processes on gloo) against the
reference's trainer on a two-device CPU mesh, from the same parameters and
the same global batches, over a full COVAP cycle plus one step, with SGD.

The reference runs its ``arena=False``, ``sync="allreduce"`` post path,
with an f32 wire, a bf16 wire and a binding global-norm clip, its
flat-bucket path with the FP8 wire (``fp8wire``) and EFsignSGD, and its
leaf-granularity path (PowerSGD, from the same starting Q).  The port
runs those paths, its sharded forms (per-segment and arena), the flat
wires' arena form and the fused overlap (allreduce, arena, sharded and
sharded + arena) against them; each fused run also equals the port's post
run of the same form bit for bit.

Both sides sum the two workers' gradients in their own order (gloo's is not
XLA's), so the comparison is allclose at the single-process SGD bound; the
bf16 wire adds the one-ulp allowance of ``_assert_matches_reference``, the
quantizing wires ``assert_quantized_wire_close``'s allowance.  The flat
wires' all-gathers carry the int8 signs and fp8 codes as uint8 (gloo
refuses float8)."""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch.multiprocessing as mp

from _torch_dist_worker import (
    adaptive_worker,
    assert_quantized_wire_close,
    train_worker,
    wire_drift,
)
from _torch_reference_runs import one_thread_env

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
WORLD = 2
STEPS = 5
LR = 1e-2
CLIP = 0.05          # below every step's grad norm, so the clip binds
TC = dict(compressor="covap", interval=4, bucket_bytes=1 << 14, max_buckets=32,
          log_every=1, steps=STEPS)
BF16 = dict(TC, compressor_options={"wire_dtype": "bfloat16"})
CLIPPED = dict(TC, clip_norm=CLIP)
DATA = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)

FP8 = dict(TC, compressor="fp8wire")
SIGN = dict(TC, compressor="efsignsgd")
POWERSGD = dict(TC, compressor="powersgd")

REFERENCE_RUNS = {"allreduce": TC, "allreduce-bf16": BF16, "allreduce-clip": CLIPPED,
                  "fp8wire": FP8, "efsignsgd": SIGN, "powersgd": POWERSGD}
PORT_RUNS = {
    "allreduce": TC,
    "sharded": dict(TC, sync="sharded"),
    "sharded-arena": dict(TC, sync="sharded", arena=True),
    "allreduce-bf16": BF16,
    "sharded-bf16": dict(BF16, sync="sharded"),
    "sharded-arena-bf16": dict(BF16, sync="sharded", arena=True),
    "allreduce-clip": CLIPPED,
    "sharded-clip": dict(CLIPPED, sync="sharded"),
    "fp8wire": FP8,
    "fp8wire-arena": dict(FP8, arena=True),
    "efsignsgd": SIGN,
    "efsignsgd-arena": dict(SIGN, arena=True),
    "powersgd": POWERSGD,
    "fused": dict(TC, overlap="fused"),
    "arena": dict(TC, arena=True),
    "fused-arena": dict(TC, overlap="fused", arena=True),
    "fused-sharded": dict(TC, overlap="fused", sync="sharded"),
    "fused-sharded-arena": dict(TC, overlap="fused", sync="sharded", arena=True),
}
# each fused run and the post run of its form
FUSED_RUNS = {"fused": "allreduce", "fused-arena": "arena",
              "fused-sharded": "sharded", "fused-sharded-arena": "sharded-arena"}

REFERENCE = """
import os
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_reduced
from repro.data import DataConfig, make_loader
from repro.models import build_model
from repro.optim import sgd
from repro.train.trainer import TrainConfig, Trainer

def flat(tree, prefix=""):
    out = {{}}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out

def indexed(name, part, leaves):
    return {{name + "/" + part + ":" + str(i): np.asarray(x)
             for i, x in enumerate(leaves) if x is not None}}

mesh = Mesh(np.array(jax.devices()[:{world}]), ("data",))
out, comp0 = {{}}, {{}}
for name, tc in {runs}.items():
    tr = Trainer(build_model(get_reduced("gpt2-paper")), sgd({lr}, momentum=0.9),
                 TrainConfig(**tc), mesh=mesh, dp_axes=("data",))
    state = tr.init_state(jax.random.PRNGKey(0))
    if not os.path.exists({init!r}):     # written whole, then renamed
        part = {init!r} + f".{{os.getpid()}}.npz"
        np.savez(part, **flat(state["params"]))
        os.replace(part, {init!r})
    leaf_state = set(state["comp"]) == {{"q", "residual"}}    # PowerSGD's state
    if leaf_state:
        comp0.update(indexed(name, "q", state["comp"]["q"]))
    state = tr.run(state, iter(make_loader(DataConfig(**{data}))), log=None)
    out[name + "/losses"] = np.array([h["loss"] for h in tr.history])
    out[name + "/grad_norm"] = np.array([h["grad_norm"] for h in tr.history])
    parts = [("params", state["params"]), ("mu", state["opt"]["mu"])]
    if leaf_state:
        out.update(indexed(name, "resid", state["comp"]["residual"]))
        out.update(indexed(name, "q", state["comp"]["q"]))
    else:
        parts.append(("resid", state["comp"]))
    for part, tree in parts:
        out.update({{name + "/" + part + ":" + k: v for k, v in flat(tree).items()}})
np.savez({out!r}, **out)
np.savez({init_comp!r}, **comp0)
"""


def _init_comp(init):
    """Where the reference writes each PowerSGD run's starting Q."""
    return init.removesuffix(".npz") + "-comp.npz"


# the reference's runs go to this many subprocesses, run at once (one a
# run); each writes the same initial parameters (PRNGKey(0)) and its runs
REFERENCE_PROCESSES = 3


def _start_reference(init, out):
    """Start every run of ``REFERENCE_RUNS`` on the reference's 2-device CPU
    mesh, in ``REFERENCE_PROCESSES`` subprocesses at once, XLA on one thread
    each (``_torch_reference_runs.one_thread_env``); the first to initialise
    writes the initial parameters to ``init``.  -> the processes and their
    output paths, for :func:`_finish_reference`."""
    env = one_thread_env(dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}"))
    names = list(REFERENCE_RUNS)
    procs = []
    for g in range(REFERENCE_PROCESSES):
        paths = (f"{out}.{g}.npz", f"{init}.comp{g}.npz")
        runs = {n: REFERENCE_RUNS[n] for n in names[g::REFERENCE_PROCESSES]}
        code = REFERENCE.format(world=WORLD, lr=LR, runs=runs, data=DATA, init=init,
                                out=paths[0], init_comp=paths[1])
        procs.append((paths, subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)))
    return procs


def _finish_reference(procs, init, out):
    """Wait for :func:`_start_reference`'s processes and merge their
    outputs into ``out`` and ``_init_comp(init)``."""
    try:
        for _, p in procs:
            _, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, stderr[-4000:]
    finally:
        _kill(p for _, p in procs)
    merged, comp = {}, {}
    for (out_g, comp_g), _ in procs:
        merged.update(np.load(out_g))
        comp.update(np.load(comp_g))
    np.savez(out, **merged)
    np.savez(_init_comp(init), **comp)


def _run_reference(init, out):
    _finish_reference(_start_reference(init, out), init, out)


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _wait_for(path, procs, timeout=600):
    """Wait until ``path`` exists; fail early when a process exits non-zero."""
    for _ in range(int(timeout / 0.2)):
        if os.path.exists(path):
            return
        bad = [p for _, p in procs if p.poll() not in (None, 0)]
        assert not bad, bad[0].communicate()[1][-4000:]
        time.sleep(0.2)
    raise AssertionError(f"{path} was not written within {timeout} s")


def _join(ctx, timeout=600):
    for _ in range(timeout):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        raise AssertionError(f"gloo workers did not finish within {timeout} s")
    assert not any(p.is_alive() for p in ctx.processes)


def _start(worker, args):
    return mp.start_processes(worker, args=args, nprocs=WORLD, join=False,
                              start_method="spawn")


def _spawn(worker, args, tmp_path, prefix):
    """Run ``worker(rank, *args)`` on ``WORLD`` spawned processes; -> each
    rank's ``<prefix><rank>.npz``."""
    _join(_start(worker, args))
    return [dict(np.load(tmp_path / f"{prefix}{r}.npz")) for r in range(WORLD)]


def _port_args(tmp_path, init, name, runs, init_comp=None):
    return (WORLD, str(tmp_path / f"rendezvous-{name}"), init, str(tmp_path / name), runs,
            DATA, "sgd", LR, STEPS, init_comp)


def _run_port(tmp_path, init):
    return _spawn(train_worker, _port_args(tmp_path, init, "port", PORT_RUNS,
                                           _init_comp(init)), tmp_path, "port")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (reference, [rank 0, rank 1]): every run of both sides, once.  The
    port's runs start as soon as the reference has written the initial
    parameters; its PowerSGD run, which starts from the reference's Q,
    once the reference is done."""
    tmp = tmp_path_factory.mktemp("multiworker")
    init, out = str(tmp / "init.npz"), str(tmp / "ref.npz")
    procs = _start_reference(init, out)
    early = None
    try:
        _wait_for(init, procs)
        first = {k: v for k, v in PORT_RUNS.items() if v["compressor"] != "powersgd"}
        early = _start(train_worker, _port_args(tmp, init, "port-a", first))
        _finish_reference(procs, init, out)
        late = _spawn(train_worker, _port_args(
            tmp, init, "port-b", {k: v for k, v in PORT_RUNS.items() if k not in first},
            _init_comp(init)), tmp, "port-b")
        _join(early)
    finally:
        _kill(p for _, p in procs)
        if early is not None:
            for p in early.processes:
                if p.is_alive():
                    p.kill()
    ranks = [{**dict(np.load(tmp / f"port-a{r}.npz")), **late[r]} for r in range(WORLD)]
    return dict(np.load(out)), ranks


def _part(run, tree, part):
    prefix = f"{run}/{part}:"
    return {k[len(prefix):]: v for k, v in tree.items() if k.startswith(prefix)}


def _assert_close(got, want, err_msg, *, wire_ulp=None):
    """allclose at the f32 bound (rtol 1e-4, atol 1e-6).  With a bf16 wire
    (``wire_ulp``: one bf16 unit in the last place of this part's largest
    reference value), at most 1/500 of the elements may lie outside that
    bound, and those by at most ``wire_ulp``."""
    if wire_ulp is None:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=err_msg)
        return
    d = np.abs(got - want)
    over = d > 1e-6 + 1e-4 * np.abs(want)
    assert over.sum() <= want.size / 500, (err_msg, int(over.sum()), want.size)
    assert np.all(d <= wire_ulp), (err_msg, float(d.max()), wire_ulp)


def _assert_matches_reference(ranks, ref, run, ref_run):
    """The reference's jit contracts ``g + c*r`` into an FMA, the port rounds
    twice (``ROADMAP.md`` queue 3), so ``t`` differs in its last f32 bit.
    With a bf16 wire, where that puts ``t`` on the other side of a bf16
    rounding boundary, the wire value, and with it the momentum and the
    residual, differ by one bf16 ulp (about 0.08% of the elements after 5
    steps); a param moves by at most ``LR`` times that ulp per step.  The
    f32 wire has no such elements."""
    tol = dict.fromkeys(("params", "mu", "resid"))
    if "bf16" in run:
        def ulp(part):                        # one bf16 ulp of the largest value
            mx = max(float(np.max(np.abs(v)))
                     for v in _part(ref_run, ref, part).values())
            return 2.0 ** (np.floor(np.log2(mx)) - 7)

        tol = {"params": STEPS * LR * ulp("mu"), "mu": ulp("mu"),
               "resid": ulp("resid")}
    for got in ranks:
        np.testing.assert_allclose(got[f"{run}/losses"], ref[f"{ref_run}/losses"],
                                   rtol=1e-5, err_msg=run)
        for part in ("params", "mu"):
            want = _part(ref_run, ref, part)
            assert want
            for key, v in want.items():
                _assert_close(got[f"{run}/{part}:{key}"], v, f"{run} {part}:{key}",
                              wire_ulp=tol[part])
    # parameters and momenta are replicated; each rank keeps its own residuals
    for part in ("params", "mu"):
        for key, v in _part(run, ranks[0], part).items():
            np.testing.assert_array_equal(v, ranks[1][f"{run}/{part}:{key}"])
    # the reference hands back the first device's residuals
    want = _part(ref_run, ref, "resid")
    assert want
    for key, v in want.items():
        _assert_close(ranks[0][f"{run}/resid:{key}"], v, f"{run} resid:{key}",
                      wire_ulp=tol["resid"])
    assert any(not np.array_equal(v, ranks[1][f"{run}/resid:{key}"])
               for key, v in _part(run, ranks[0], "resid").items())


def test_two_worker_gloo_trainer_matches_reference_cpu_mesh(runs):
    ref, ranks = runs
    _assert_matches_reference(ranks, ref, "allreduce", "allreduce")


@pytest.mark.parametrize("run,ref_run", [
    ("sharded", "allreduce"),
    ("sharded-arena", "allreduce"),
    ("allreduce-bf16", "allreduce-bf16"),
    ("sharded-bf16", "allreduce-bf16"),
    ("sharded-arena-bf16", "allreduce-bf16"),
    ("allreduce-clip", "allreduce-clip"),
    ("sharded-clip", "allreduce-clip"),
])
def test_two_worker_gloo_sync_forms_match_reference_cpu_mesh(runs, run, ref_run):
    """The port's sharded forms (W-aligned reduce-scatter into the owner's
    shard, zeros elsewhere, the head all-gather, the sharded grad norm and
    the flush of params and momenta), its bf16 wire and its clip, each held
    against the reference's allreduce run of the same options."""
    ref, ranks = runs
    _assert_matches_reference(ranks, ref, run, ref_run)
    for got in ranks:
        np.testing.assert_allclose(got[f"{run}/grad_norm"],
                                   ref[f"{ref_run}/grad_norm"], rtol=1e-5)
    if ref_run == "allreduce-clip":
        assert np.all(ref[f"{ref_run}/grad_norm"] > CLIP)


@pytest.mark.parametrize("run", ["fp8wire", "fp8wire-arena", "efsignsgd",
                                 "efsignsgd-arena"])
def test_two_worker_gloo_flat_wires_match_reference_cpu_mesh(runs, run):
    """The flat-bucket path at W=2: each worker's fp8 codes and scales (or
    int8 signs and scale) all-gathered and decoded as the mean of the two
    contributions, residual ``t - sent``; against the reference's two-device
    run of the same compressor.  Losses at rtol 1e-5, grad norms at rtol
    1e-4, params, momenta and residuals within
    ``assert_quantized_wire_close``'s allowance; params and momenta
    replicated bit for bit; the arena form equal to the per-bucket form bit
    for bit on each rank.  ``python tests/test_torch_multiworker.py`` prints
    rank 0's drift."""
    ref, ranks = runs
    ref_run = run.removesuffix("-arena")
    mu_max = max(float(np.max(np.abs(v))) for v in _part(ref_run, ref, "mu").values())
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{run}/losses"], ref[f"{ref_run}/losses"],
                                   rtol=1e-5, err_msg=run)
        np.testing.assert_allclose(got[f"{run}/grad_norm"],
                                   ref[f"{ref_run}/grad_norm"], rtol=1e-4)
        # the reference hands back the first device's residuals
        for part in ("params", "mu") + (("resid",) if rank == 0 else ()):
            want = _part(ref_run, ref, part)
            assert want
            assert_quantized_wire_close(
                part, [got[f"{run}/{part}:{k}"] for k in want], list(want.values()),
                steps=STEPS, lr=LR, mu_max=mu_max, err_msg=f"{run} rank {rank} {part}")
        if run != ref_run:
            for key, v in got.items():
                if key.startswith(ref_run + "/"):
                    np.testing.assert_array_equal(
                        got[key.replace(ref_run, run, 1)], v, err_msg=key)
    for part in ("params", "mu"):
        for key, v in _part(run, ranks[0], part).items():
            np.testing.assert_array_equal(v, ranks[1][f"{run}/{part}:{key}"])
    assert any(not np.array_equal(v, ranks[1][f"{run}/resid:{key}"])
               for key, v in _part(run, ranks[0], "resid").items())


@pytest.mark.parametrize("run", sorted(FUSED_RUNS))
def test_two_worker_gloo_fused_overlap_matches_post_and_reference(runs, run):
    """Each fused form at W=2 (every bucket's collective started inside the
    backward pass, waited for after it): bit for bit the port's post run
    of the same form on each rank (losses, grad norms, params, momenta,
    residuals, the sharded head gather's events), and held against the
    reference's allreduce run as the post forms are.  The hooks fired in
    the same order on both ranks."""
    ref, ranks = runs
    post = FUSED_RUNS[run]
    for got in ranks:
        keys = [k for k in got if k.startswith(post + "/")]
        assert len(keys) > 3
        for key in keys + [f"trace/{post}/gather_events"]:
            np.testing.assert_array_equal(got[key.replace(post, run, 1)], got[key],
                                          err_msg=key)
        fired = got[f"trace/{run}/fired"].tolist()
        assert len(fired) == len(set(fired)) > 8
        assert len(got[f"trace/{post}/fired"]) == 0
        assert (len(got[f"trace/{run}/gather_events"]) > 0) == ("sharded" in run)
    np.testing.assert_array_equal(ranks[0][f"trace/{run}/fired"],
                                  ranks[1][f"trace/{run}/fired"])
    _assert_matches_reference(ranks, ref, run, "allreduce")


def test_two_worker_gloo_powersgd_matches_reference_cpu_mesh(runs):
    """PowerSGD at W=2 from the reference's starting Q: P and Q' are
    all-reduced (mean) between the QR and the products, so Q, params and
    momenta stay replicated bit for bit while each rank keeps its own
    residual.  Against the reference's two-device run: losses and grad norms
    at rtol 1e-5; params at the float32 bound (rtol 1e-4, atol 1e-6);
    momenta, residuals (rank 0's, as the reference hands back the first
    device's) and Q at rtol 1e-4, atol 1e-4 of the part's largest reference
    value: the warm-started Q carries the frameworks' last-bit differences
    from step to step (``python tests/test_torch_multiworker.py`` prints
    the drift)."""
    ref, ranks = runs
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got["powersgd/losses"], ref["powersgd/losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["powersgd/grad_norm"],
                                   ref["powersgd/grad_norm"], rtol=1e-5)
        for part in ("params", "mu", "q") + (("resid",) if rank == 0 else ()):
            want = _part("powersgd", ref, part)
            assert want and set(want) == set(_part("powersgd", got, part))
            scale = max(float(np.max(np.abs(v))) for v in want.values())
            rtol, atol = (1e-4, 1e-6) if part == "params" else (1e-4, 1e-4 * scale)
            for key, v in want.items():
                np.testing.assert_allclose(got[f"powersgd/{part}:{key}"], v, rtol=rtol,
                                           atol=atol, err_msg=f"rank {rank} {part}:{key}")
    for part in ("params", "mu", "q"):
        for key, v in _part("powersgd", ranks[0], part).items():
            np.testing.assert_array_equal(v, ranks[1][f"powersgd/{part}:{key}"])
    assert any(not np.array_equal(v, ranks[1][f"powersgd/resid:{key}"])
               for key, v in _part("powersgd", ranks[0], "resid").items())


def test_two_worker_gloo_adaptive_ranks_make_the_same_decisions(tmp_path):
    """Each rank runs its own ``AdaptiveRuntime``.  With a synthetic probe
    that reports CCR 1.2 on rank 0 (inside I = 2's band) and 3.4 on rank 1
    (I = 4), both ranks see the group's maximum and re-plan at the same
    step to I = 4, so their plans' collectives keep matching; their params
    stay equal bit for bit.  The real probe's samples (its schedule-only
    all-reduces on the group) are the same on both ranks, and a run that
    never re-plans with it equals the ``autotune=None`` run bit for bit."""
    ranks = _spawn(adaptive_worker,
                   (WORLD, str(tmp_path / "rendezvous"), str(tmp_path / "adaptive"),
                    dict(TC, interval=2), DATA, LR, STEPS, (1.2, 3.4)),
                   tmp_path, "adaptive")
    params = [k for k in ranks[0] if k.startswith("static/params:")]
    assert len(params) > 8
    for got in ranks:
        assert int(got["skew/interval"]) == 4 and list(got["skew/replan_steps"]) == [1]
        # rank 1's t_comm over the common t_comp
        np.testing.assert_array_equal(got["skew/measured_ccr"],
                                      [0.01 * 3.4 / 0.01] * (STEPS - 1))
        assert int(got["real/interval"]) == 2 and len(got["real/replan_steps"]) == 0
        assert got["real/samples"].shape == (STEPS, 3) and (got["real/samples"] > 0).all()
        for key in params:
            np.testing.assert_array_equal(got[key.replace("static", "real", 1)], got[key],
                                          err_msg=key)
            resid = key.replace("params", "resid")
            np.testing.assert_array_equal(got[resid.replace("static", "real", 1)],
                                          got[resid], err_msg=resid)
    for key in ranks[0]:
        if "resid" not in key:
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)


if __name__ == "__main__":
    # rank 0's drift from the reference on the quantizing wires and PowerSGD,
    # at W=2
    import tempfile
    from pathlib import Path

    REFERENCE_RUNS = {k: REFERENCE_RUNS[k] for k in ("fp8wire", "efsignsgd", "powersgd")}
    PORT_RUNS = {k: PORT_RUNS[k] for k in ("fp8wire", "efsignsgd", "powersgd")}
    with tempfile.TemporaryDirectory() as tmp:
        init, out = str(Path(tmp) / "init.npz"), str(Path(tmp) / "ref.npz")
        _run_reference(init, out)
        ref, ranks = dict(np.load(out)), _run_port(Path(tmp), init)
    for wire in PORT_RUNS:
        for part in ("params", "mu", "resid") + (("q",) if wire == "powersgd" else ()):
            want = _part(wire, ref, part)
            got = [ranks[0][f"{wire}/{part}:{k}"] for k in want]
            drift = wire_drift(got, list(want.values()))
            print(wire, part, drift, drift["max"] / drift["max_want"])
