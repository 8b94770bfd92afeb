"""The port's checkpoint store (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``), and resume.

* The store: a round trip (bfloat16, host ints and ``None`` holes
  included) bit for bit; a missing leaf raises ``KeyError``, a shape
  mismatch ``ValueError``, a corrupt payload ``CheckpointCorruptError``
  (not a ``ValueError``, so the comp-structure fallback cannot swallow it);
  a manifest without ``arrays.npz`` is corrupt; the staging directory is
  invisible to ``latest_step``.  Each package's ``verify`` and
  ``latest_step`` accept the other's step directory.
* Resume: on REDUCED, AdamW, a run that saves after 2 steps and trains 3
  more equals a fresh trainer restored from the save and fed the same 3
  batches, bit for bit in params, moments, residuals (PowerSGD's Q too)
  and both steps, on the defaults, the arena, ``fp8wire`` and
  ``powersgd``.  The comp-structure drift and another world size fall back
  to a fresh comp state.
* Two gloo workers, on the defaults and under ``sync="sharded"``: each rank
  restores its own residual, and resume equals the uninterrupted run bit
  for bit on every rank.
* The port's resume against the reference's resume, at the tolerance of
  the trainer tests (SGD: rtol 1e-4, atol 1e-6).
* The reference's problem at W > 1: its checkpoint keeps worker 0's
  residual only (a two-device CPU mesh in a subprocess).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import repro.checkpoint as rckpt
import repro.configs as rconfigs
from repro.data import DataConfig as RDataConfig
from repro.data import make_loader as r_make_loader
from repro.models import build_model as r_build_model
from repro.optim import sgd as r_sgd
from repro.train.trainer import TrainConfig as RTrainConfig
from repro.train.trainer import Trainer as RTrainer

import repro_torch.checkpoint as ckpt
import repro_torch.configs as tconfigs
from repro_torch import optim
from repro_torch.data import DataConfig, make_loader
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.train import TrainConfig, Trainer

from _torch_dist_worker import ckpt_worker

torch.set_num_threads(2)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TC = dict(compressor="covap", interval=4, bucket_bytes=1 << 14, max_buckets=32,
          log_every=1)
DATA = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)
BEFORE, AFTER = 2, 3
LR = 1e-2


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": [torch.randn(3, 4, generator=g),
                   torch.randn(5, generator=g).to(torch.bfloat16)],
        "opt": {"step": 7, "m": [torch.randn(3, 4, generator=g), torch.zeros(5)]},
        "comp": {"q": [torch.randn(4, 2, generator=g), None],
                 "residual": [None, torch.arange(5, dtype=torch.int32)]},
        "step": 11,
    }


def _zeros_like(tree):
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return 0 if isinstance(tree, int) else tree


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def test_store_round_trip_bitwise(tmp_path):
    tree = _tree()
    d = ckpt.save(str(tmp_path), 11, tree, extra={"interval": 4})
    assert d == str(tmp_path / "step_00000011")
    assert sorted(os.listdir(d)) == ["arrays.npz", "manifest.json"]
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    assert manifest["step"] == 11 and manifest["extra"] == {"interval": 4}
    assert manifest["digest"].startswith("sha256:")
    assert manifest["leaves"]["params/1"]["dtype"] == "bfloat16"
    assert {k: v for k, v in manifest["leaves"]["opt/step"].items() if k != "name"} \
        == {"dtype": "int64", "shape": []}
    like = _zeros_like(tree)
    got = ckpt.restore(str(tmp_path), 11, like)
    assert _same(got, tree)
    assert got["params"][0] is like["params"][0]      # filled in place
    assert got["comp"]["q"][1] is None and got["comp"]["residual"][0] is None
    assert ckpt.load_extra(str(tmp_path), 11) == {"interval": 4}
    assert ckpt.latest_step(str(tmp_path)) == 11


def test_missing_leaf_and_shape_mismatch(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 1, tree)
    like = _zeros_like(tree)
    like["opt"]["v"] = [torch.zeros(3)]
    with pytest.raises(KeyError, match="opt/v/0"):
        ckpt.restore(str(tmp_path), 1, like)
    like = _zeros_like(tree)
    like["params"][0] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape mismatch for params/0"):
        ckpt.restore(str(tmp_path), 1, like)
    # a failed restore writes nothing
    assert not like["params"][1].any()


def test_corrupt_and_partial_checkpoints(tmp_path):
    ckpt.save(str(tmp_path), 3, _tree())
    npz = tmp_path / "step_00000003" / "arrays.npz"
    data = bytearray(npz.read_bytes())
    data[len(data) // 2] ^= 0xFF
    npz.write_bytes(bytes(data))
    assert not issubclass(ckpt.CheckpointCorruptError, ValueError)
    with pytest.raises(ckpt.CheckpointCorruptError, match="digest"):
        ckpt.verify(str(tmp_path), 3)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(str(tmp_path), 3, _zeros_like(_tree()))
    npz.unlink()
    with pytest.raises(ckpt.CheckpointCorruptError, match="no arrays.npz"):
        ckpt.verify(str(tmp_path), 3)


def test_staging_directory_is_invisible(tmp_path):
    ckpt.save(str(tmp_path), 2, _tree())
    os.makedirs(tmp_path / ".tmp_step_00000009")     # a crash mid-save
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert ckpt.latest_step(str(tmp_path / "absent")) is None
    ckpt.save(str(tmp_path), 9, _tree(1))          # the stray staging dir is reused
    assert ckpt.latest_step(str(tmp_path)) == 9
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000009"]


def test_each_package_reads_the_others_step_dir(tmp_path):
    import jax.numpy as jnp

    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    rckpt.save(rdir, 5, {"w": jnp.ones((2, 3)), "b": jnp.zeros(4, jnp.bfloat16)})
    ckpt.save(pdir, 6, _tree())
    assert ckpt.latest_step(rdir) == 5 and rckpt.latest_step(pdir) == 6
    assert ckpt.verify(rdir, 5) == rckpt.verify(rdir, 5)
    assert rckpt.verify(pdir, 6) == ckpt.verify(pdir, 6)
    rmeta = json.load(open(os.path.join(rdir, "step_00000005", "manifest.json")))
    pmeta = json.load(open(os.path.join(pdir, "step_00000006", "manifest.json")))
    assert set(rmeta) == set(pmeta) == {"step", "leaves", "digest", "extra"}
    assert rmeta["leaves"]["['b']"]["dtype"] == pmeta["leaves"]["params/1"]["dtype"]
    # the port's bf16 payload decodes as the reference decodes its own
    meta = pmeta["leaves"]["params/1"]
    with np.load(os.path.join(pdir, "step_00000006", "arrays.npz")) as data:
        decoded = data[meta["name"]].view(jnp.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(decoded, _tree()["params"][1].float().numpy())


# ---------------------------------------------------------------------------
# resume on REDUCED
# ---------------------------------------------------------------------------

RESUME_CASES = {
    "defaults": {},
    "arena": {"arena": True},
    "fp8wire": {"compressor": "fp8wire"},
    "powersgd": {"compressor": "powersgd"},
}


def _trainer(init, **kw):
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu")
    model.load_state_dict(init)
    tr = Trainer(model, optim.adamw(1e-3), TrainConfig(**dict(TC, **kw)))
    return tr, tr.init_state()


def _parts(tr, state):
    out = {"params": state["params"], "m": state["opt"]["m"],
           "v": state["opt"]["v"]}
    comp = state["comp"]
    if isinstance(comp, dict):
        out.update(q=comp["q"], resid=comp["residual"])
    else:
        out["resid"] = comp
    return ({k: [None if x is None else x.detach().clone() for x in v]
             for k, v in out.items()}, (state["step"], state["opt"]["step"]))


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_equals_uninterrupted_run_bitwise(tmp_path, case):
    kw = RESUME_CASES[case]
    init = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu",
                       seed=5).state_dict()
    loader = make_loader(DataConfig(**DATA), device="cpu")
    batches = [loader.make(s) for s in range(BEFORE + AFTER)]

    tr, state = _trainer(init, **kw)
    state = tr.run(state, iter(batches[:BEFORE]), steps=BEFORE, log=None)
    ckpt.save_train_state(str(tmp_path), state, interval=tr.tc.interval,
                          names=tr.leaf_names)
    state = tr.run(state, iter(batches[BEFORE:]), steps=AFTER, log=None)
    want, want_steps = _parts(tr, state)

    tr, state = _trainer(init, **kw)
    state, extra = ckpt.restore_train_state(str(tmp_path), state,
                                            names=tr.leaf_names)
    assert extra["comp_restored"] and extra["interval"] == 4 and extra["world"] == 1
    assert extra["has_comp_state"]
    assert state["step"] == BEFORE and isinstance(state["opt"]["step"], int)
    assert state["params"][0] is tr.model.named_leaves()[0][1]
    state = tr.run(state, iter(batches[BEFORE:]), steps=AFTER, log=None)
    got, got_steps = _parts(tr, state)
    assert got_steps == want_steps == (BEFORE + AFTER, BEFORE + AFTER)
    for part in want:
        assert [x is None for x in got[part]] == [x is None for x in want[part]]
        for a, b in zip(got[part], want[part]):
            assert b is None or torch.equal(a, b), part
    assert any(bool(r.any()) for r in want["resid"] if r is not None)


def test_leaf_keys_are_dotted_names(tmp_path):
    init = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu").state_dict()
    tr, state = _trainer(init)
    ckpt.save_train_state(str(tmp_path), state, interval=4, names=tr.leaf_names)
    keys = set(json.load(open(tmp_path / "step_00000000" / "manifest.json"))["leaves"])
    n = len(tr.leaf_names)
    assert len(keys) == 4 * n + 2
    assert {"step", "opt/step", "opt/m/stack.blocks.b0.attn.wq",
            "comp/embed.table", "params/head.w"} <= keys
    # another leaf set fails loudly
    with pytest.raises(KeyError):
        ckpt.restore_train_state(str(tmp_path), state,
                                 names=[f"x{i}" for i in range(n)])


def test_comp_structure_drift_keeps_a_fresh_comp_state(tmp_path):
    init = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu").state_dict()
    tr, state = _trainer(init)
    loader = make_loader(DataConfig(**DATA), device="cpu")
    state = tr.run(state, loader, steps=2, log=None)
    ckpt.save_train_state(str(tmp_path), state, interval=4, names=tr.leaf_names)
    for kw in ({"interval": 1}, {"compressor": "powersgd"}):   # no EF; leaf state
        tr2, fresh = _trainer(init, **kw)
        like_comp = fresh["comp"]
        got, extra = ckpt.restore_train_state(str(tmp_path), fresh,
                                              names=tr2.leaf_names)
        assert extra["comp_restored"] is False
        assert got["comp"] is like_comp
        assert all(torch.equal(a, b) for a, b in zip(got["params"], state["params"]))


def test_corruption_is_not_swallowed_by_the_fallback(tmp_path):
    init = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu").state_dict()
    tr, state = _trainer(init)
    d = ckpt.save_train_state(str(tmp_path), state, interval=4, names=tr.leaf_names)
    with open(os.path.join(d, "arrays.npz"), "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore_train_state(str(tmp_path), _trainer(init)[1], names=tr.leaf_names)


def test_cli_saves_and_resumes_into_another_interval(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
            "--seq-len", "16", "--global-batch", "4", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--log-every", "1"]
    r = subprocess.run(base + ["--steps", "4", "--interval", "4"], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("[ckpt] saved") == 2
    r = subprocess.run(base + ["--steps", "2", "--interval", "2", "--resume"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[ckpt] resumed step 4" in r.stdout
    assert "[ckpt] interval 4 -> 2: residual carry" in r.stdout
    assert "step     5" in r.stdout and "step_00000006" in r.stdout


# ---------------------------------------------------------------------------
# two gloo workers: each rank's own residual
# ---------------------------------------------------------------------------

def _spawn(worker, args, nprocs, timeout=300):
    ctx = mp.start_processes(worker, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    for _ in range(timeout):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        raise AssertionError(f"gloo workers did not finish within {timeout} s")


@pytest.mark.parametrize("sync", ["allreduce", "sharded"])
def test_two_workers_each_restore_their_own_residual(tmp_path, sync):
    init = str(tmp_path / "init.npz")
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu", seed=2)
    np.savez(init, **{k: v.numpy() for k, v in model.state_dict().items()})
    ckpt_dir = str(tmp_path / "ckpt")
    _spawn(ckpt_worker, (2, str(tmp_path / "rdv"), init, ckpt_dir,
                         str(tmp_path / "out"), dict(TC, sync=sync), DATA, 1e-3,
                         BEFORE, AFTER), 2)
    ranks = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    for got in ranks:
        keys = [k for k in got if k.startswith("A/")]
        assert len(keys) > 40
        for k in keys:
            np.testing.assert_array_equal(got["B/" + k[2:]], got[k], err_msg=k)
        for k in (k for k in got if k.startswith("saved/")):
            np.testing.assert_array_equal(got["restored/" + k[6:]], got[k], err_msg=k)
    differ = [k for k in ranks[0] if k.startswith("saved/")
              and not np.array_equal(ranks[0][k], ranks[1][k])]
    assert differ, "the two ranks' residuals are alike; the test shows nothing"
    for part in ("params", "m", "v"):
        for k in (k for k in ranks[0] if k.startswith(f"A/{part}:")):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    manifest = json.load(open(os.path.join(ckpt_dir, "step_00000002", "manifest.json")))
    assert manifest["extra"]["world"] == 2 and set(manifest["ranks"]) == {"1"}
    assert sorted(os.listdir(os.path.join(ckpt_dir, "step_00000002"))) == [
        "arrays.npz", "comp_rank00001.npz", "manifest.json"]
    assert rckpt.verify(ckpt_dir, 2) == ckpt.verify(ckpt_dir, 2)

    # one worker reading the two-worker checkpoint: params, fresh residuals
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu")
    tr = Trainer(model, optim.adamw(1e-3), TrainConfig(**dict(TC, sync=sync)))
    fresh = tr.init_state()
    with pytest.warns(RuntimeWarning, match="2 worker"):
        state, extra = ckpt.restore_train_state(ckpt_dir, fresh, step=2,
                                                names=tr.leaf_names)
    assert extra["comp_restored"] is False
    assert not any(bool(r.any()) for r in state["comp"])
    for path, p in zip(tr.leaf_names, state["params"]):
        np.testing.assert_array_equal(p.detach().numpy(), ranks[0][f"saved_params/{path}"])


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_resume_matches_the_reference_resume(tmp_path):
    """Both packages train 2 SGD steps, save, restore into a fresh state and
    train 3 more; the port's result is held against the reference's at the
    trainer tests' bound (rtol 1e-4, atol 1e-6), losses at rtol 1e-5."""
    tc = dict(TC, steps=AFTER)
    rtr = RTrainer(r_build_model(rconfigs.get_reduced("gpt2-paper")),
                   r_sgd(LR, momentum=0.9), RTrainConfig(**tc))
    rstate = rtr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, rstate["params"])
    rit = iter(r_make_loader(RDataConfig(**DATA)))
    rbatches = [next(rit) for _ in range(BEFORE + AFTER)]
    rstate = rtr.run(rstate, iter(rbatches[:BEFORE]), steps=BEFORE, log=None)
    rckpt.save_train_state(str(tmp_path / "ref"), rstate, interval=4)
    rstate, rextra = rckpt.restore_train_state(
        str(tmp_path / "ref"), rtr.init_state(jax.random.PRNGKey(1)))
    assert rextra["comp_restored"]
    rhist = len(rtr.history)
    rstate = rtr.run(rstate, iter(rbatches[BEFORE:]), steps=AFTER, log=None)

    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu")
    model.load_state_dict(params_from_jax(init, device="cpu"))
    tr = Trainer(model, optim.sgd(LR, momentum=0.9), TrainConfig(**tc))
    loader = make_loader(DataConfig(**DATA), device="cpu")
    batches = [loader.make(s) for s in range(BEFORE + AFTER)]
    state = tr.run(tr.init_state(), iter(batches[:BEFORE]), steps=BEFORE, log=None)
    ckpt.save_train_state(str(tmp_path / "port"), state, interval=4,
                          names=tr.leaf_names)
    model.init_params(1)
    state, extra = ckpt.restore_train_state(str(tmp_path / "port"), tr.init_state(),
                                            names=tr.leaf_names)
    assert extra["comp_restored"]
    hist = len(tr.history)
    state = tr.run(state, iter(batches[BEFORE:]), steps=AFTER, log=None)

    assert state["step"] == rstate["step"] == BEFORE + AFTER
    np.testing.assert_allclose([h["loss"] for h in tr.history[hist:]],
                               [h["loss"] for h in rtr.history[rhist:]], rtol=1e-5)
    flat = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_leaves_with_path(rstate)}
    for path, p, mu, r in zip(tr.leaf_names, state["params"], state["opt"]["mu"],
                              state["comp"]):
        key = "".join(f"['{k}']" for k in path.split("."))
        for part, got in (("params", p), ("opt']['mu", mu), ("comp", r)):
            np.testing.assert_allclose(got.detach().numpy(), flat[f"['{part}']{key}"],
                                       rtol=1e-4, atol=1e-6, err_msg=f"{part} {path}")


REFERENCE_W2 = """
import json, os
import jax, numpy as np
from jax.sharding import Mesh
from repro import checkpoint
from repro.configs import get_reduced
from repro.data import DataConfig, make_loader
from repro.models import build_model
from repro.optim import sgd
from repro.train.trainer import TrainConfig, Trainer

mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
tr = Trainer(build_model(get_reduced("gpt2-paper")), sgd(1e-2, momentum=0.9),
             TrainConfig(**{tc}), mesh=mesh, dp_axes=("data",))
state = tr.run(tr.init_state(jax.random.PRNGKey(0)),
               iter(make_loader(DataConfig(**{data}))), steps=3, log=None)
d = checkpoint.save_train_state({ckpt!r}, state, interval=4)
leaves = json.load(open(os.path.join(d, "manifest.json")))["leaves"]
arrays = np.load(os.path.join(d, "arrays.npz"))
same0 = same1 = total = 0
for path, leaf in jax.tree_util.tree_leaves_with_path(state["comp"]):
    saved = arrays[leaves["['comp']" + jax.tree_util.keystr(path)]["name"]]
    dev = [np.asarray(s.data) for s in leaf.addressable_shards]
    assert len(dev) == 2 and dev[0].shape == saved.shape
    total += 1
    same0 += int(np.array_equal(saved, dev[0]))
    same1 += int(np.array_equal(saved, dev[1]))
print("LEAVES", total, "WORKER0", same0, "WORKER1", same1)
"""


def test_reference_checkpoint_keeps_only_worker_0_residual(tmp_path):
    """The reference problem the port's per-rank checkpoint does not
    inherit (``ROADMAP.md`` queue 3): on a two-device CPU mesh the
    reference's trainer keeps each device's own EF residual (declared
    replicated), and ``checkpoint.save_train_state`` writes device 0's.
    ``test_two_workers_each_restore_their_own_residual`` holds the port to
    the per-rank contract."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    code = REFERENCE_W2.format(tc=dict(TC, steps=3), data=DATA,
                               ckpt=str(tmp_path / "ckpt"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("LEAVES")][-1].split()
    total, same0, same1 = int(line[1]), int(line[3]), int(line[5])
    assert total > 10
    assert same0 == total           # what is saved is worker 0's residual ...
    assert same1 < total            # ... and worker 1's differs from it
