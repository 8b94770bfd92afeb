"""The port's trainer on two workers (two processes on gloo) against the
reference's trainer on a two-device CPU mesh, from the same parameters and
the same global batches, over a full COVAP cycle plus one step, with SGD.

The reference runs its ``arena=False``, ``sync="allreduce"`` post path,
with an f32 wire, a bf16 wire and a binding global-norm clip, its
flat-bucket path with the FP8 wire (``fp8wire``) and EFsignSGD, and its
leaf-granularity path (PowerSGD, from the same starting Q).  The port
runs those paths, its sharded forms (per-segment and arena) and the flat
wires' arena form against them.

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

import numpy as np
import pytest
import torch.multiprocessing as mp

from _torch_dist_worker import assert_quantized_wire_close, train_worker, wire_drift

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
}

REFERENCE = """
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
    np.savez({init!r}, **flat(state["params"]))
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


def _run_reference(init, out):
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    code = REFERENCE.format(world=WORLD, lr=LR, runs=REFERENCE_RUNS, data=DATA,
                            init=init, out=out, init_comp=_init_comp(init))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-4000:]


def _run_port(tmp_path, init):
    ctx = mp.start_processes(
        train_worker,
        args=(WORLD, str(tmp_path / "rendezvous"), init, str(tmp_path / "port"),
              PORT_RUNS, DATA, "sgd", LR, STEPS, _init_comp(init)),
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
    return [dict(np.load(tmp_path / f"port{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (reference, [rank 0, rank 1]): every run of both sides, once."""
    tmp = tmp_path_factory.mktemp("multiworker")
    init, out = str(tmp / "init.npz"), str(tmp / "ref.npz")
    _run_reference(init, out)
    return dict(np.load(out)), _run_port(tmp, init)


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
