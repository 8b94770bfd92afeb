"""The port's trainer on two workers (two processes on gloo) against the
reference's trainer on a two-device CPU mesh, from the same parameters and
the same global batches, over a full COVAP cycle plus one step.

Both sides sum the two workers' gradients in their own order (gloo's is not
XLA's), so the comparison is allclose at the single-process SGD bound."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch.multiprocessing as mp

from _torch_dist_worker import train_worker

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
WORLD = 2
STEPS = 5
LR = 1e-2
TC = dict(compressor="covap", interval=4, bucket_bytes=1 << 14, max_buckets=32,
          log_every=1, steps=STEPS)
DATA = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)

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

mesh = Mesh(np.array(jax.devices()[:{world}]), ("data",))
tr = Trainer(build_model(get_reduced("gpt2-paper")), sgd({lr}, momentum=0.9),
             TrainConfig(**{tc}), mesh=mesh, dp_axes=("data",))
state = tr.init_state(jax.random.PRNGKey(0))
np.savez({init!r}, **flat(state["params"]))
state = tr.run(state, iter(make_loader(DataConfig(**{data}))), log=None)
out = {{"losses": np.array([h["loss"] for h in tr.history])}}
out.update({{"params:" + k: v for k, v in flat(state["params"]).items()}})
out.update({{"resid:" + k: v for k, v in flat(state["comp"]).items()}})
np.savez({out!r}, **out)
"""


def _run_reference(init, out):
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    code = REFERENCE.format(world=WORLD, lr=LR, tc=TC, data=DATA, init=init, out=out)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-4000:]


def _run_port(tmp_path, init):
    ctx = mp.start_processes(
        train_worker,
        args=(WORLD, str(tmp_path / "rendezvous"), init, str(tmp_path / "port"),
              TC, DATA, LR, STEPS),
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


def test_two_worker_gloo_trainer_matches_reference_cpu_mesh(tmp_path):
    init, out = str(tmp_path / "init.npz"), str(tmp_path / "ref.npz")
    _run_reference(init, out)
    ref = dict(np.load(out))
    ranks = _run_port(tmp_path, init)

    for got in ranks:
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        for key in ref:
            if key.startswith("params:"):
                np.testing.assert_allclose(got[key], ref[key], rtol=1e-4,
                                           atol=1e-6, err_msg=key)
    # parameters are replicated; each rank keeps its own residuals
    for key in ranks[0]:
        if key.startswith("params:"):
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    # the reference hands back the first device's residuals
    for key in ref:
        if key.startswith("resid:"):
            np.testing.assert_allclose(ranks[0][key], ref[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)
    assert any(not np.array_equal(ranks[0][k], ranks[1][k])
               for k in ranks[0] if k.startswith("resid:"))
