"""The port's ``Trainer.run`` against ``repro.train.Trainer.run`` on the
REDUCED gpt2-paper (f32 compute), one worker, from the same parameters and
the same batches, over a full COVAP cycle plus one step (COVAP, the flat
wires and PowerSGD); and the CLI.

The reference runs its ``overlap="post"``, ``arena=False`` path (the
default), not the fused/arena/sharded equalities it fails on this tree."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.data import DataConfig as RDataConfig
from repro.data import make_loader as r_make_loader
from repro.models import build_model as r_build_model
from repro.optim import adamw as r_adamw
from repro.optim import cosine_warmup as r_cosine_warmup
from repro.optim import sgd as r_sgd
from repro.train.trainer import TrainConfig as RTrainConfig
from repro.train.trainer import Trainer as RTrainer

import repro_torch.configs as tconfigs
from repro_torch.data import DataConfig, make_loader
from repro_torch.interop import compressor_state_from_jax, params_from_jax
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_warmup, sgd
from repro_torch.train import TrainConfig, Trainer

torch.set_num_threads(2)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
STEPS = 5
TC = dict(compressor="covap", interval=4, bucket_bytes=1 << 14, max_buckets=32,
          log_every=1, steps=STEPS)
DATA = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)
LR = 1e-2


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _run_reference(opt):
    model = r_build_model(rconfigs.get_reduced("gpt2-paper"))
    tr = RTrainer(model, opt, RTrainConfig(**TC))
    state = tr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state["params"])
    state = tr.run(state, iter(r_make_loader(RDataConfig(**DATA))), log=None)
    return init, tr, state


def _run_port(init, opt):
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu")
    model.load_state_dict(params_from_jax(init, device="cpu"))
    tr = Trainer(model, opt, TrainConfig(**TC))
    state = tr.run(tr.init_state(), make_loader(DataConfig(**DATA), device="cpu"),
                   log=None)
    return tr, state


def _compare(rtr, rstate, tr, state, *, rtol, atol):
    assert state["step"] == rstate["step"] == STEPS
    np.testing.assert_allclose(
        [h["loss"] for h in tr.history], [h["loss"] for h in rtr.history],
        rtol=1e-5,
    )
    paths = [p for p, _ in tr.model.named_leaves()]
    rparams, rresid = _flat(rstate["params"]), _flat(rstate["comp"])
    for path, p, r in zip(paths, state["params"], state["comp"]):
        np.testing.assert_allclose(p.detach().numpy(), rparams[path],
                                   rtol=rtol, atol=atol, err_msg=path)
        np.testing.assert_allclose(r.numpy(), rresid[path],
                                   rtol=rtol, atol=atol, err_msg=path)


def test_trainer_sgd_matches_reference():
    init, rtr, rstate = _run_reference(r_sgd(LR, momentum=0.9))
    tr, state = _run_port(init, sgd(LR, momentum=0.9))
    assert tr.schedule_report() == rtr.schedule_report()
    _compare(rtr, rstate, tr, state, rtol=1e-4, atol=1e-6)


def test_trainer_adamw_matches_reference():
    """Adam divides by ``sqrt(v) + eps``: where a gradient element is near
    zero (|g| ~ eps) an ulp of difference in ``g`` moves the step by up to
    ``lr``, whatever ``g``'s size.  So params are held to ``atol = 2 * lr
    * steps`` (the most two runs can drift apart), and in addition 99.9% of
    elements to the SGD bound; residuals and losses stay tight."""
    lr = 1e-3
    init, rtr, rstate = _run_reference(r_adamw(r_cosine_warmup(lr, 1, STEPS)))
    tr, state = _run_port(init, adamw(cosine_warmup(lr, 1, STEPS)))
    _compare(rtr, rstate, tr, state, rtol=1e-4, atol=2 * lr * STEPS)
    rparams = _flat(rstate["params"])
    close = total = 0
    for (path, _), p in zip(tr.model.named_leaves(), state["params"]):
        ok = np.isclose(p.detach().numpy(), rparams[path], rtol=1e-4, atol=1e-6)
        close += int(ok.sum())
        total += ok.size
    assert close / total > 0.999


def _flat_wire_runs(name):
    """The reference trainer and the port's, with and without the arena,
    over 5 SGD steps of ``compressor=name`` from the same parameters.
    -> ``(reference trainer, reference parts, [(trainer, parts), ...])``;
    parts are ``{"params", "mu", "resid"}`` leaf lists as numpy arrays."""
    tc = dict(TC, compressor=name)
    rtr = RTrainer(r_build_model(rconfigs.get_reduced("gpt2-paper")),
                   r_sgd(LR, momentum=0.9), RTrainConfig(**tc))
    rstate = rtr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, rstate["params"])
    rstate = rtr.run(rstate, iter(r_make_loader(RDataConfig(**DATA))), log=None)
    want = {part: [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
            for part, tree in (("params", rstate["params"]),
                               ("mu", rstate["opt"]["mu"]), ("resid", rstate["comp"]))}
    runs = []
    for arena in (False, True):
        model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu")
        model.load_state_dict(params_from_jax(init, device="cpu"))
        tr = Trainer(model, sgd(LR, momentum=0.9), TrainConfig(arena=arena, **tc))
        state = tr.run(tr.init_state(), make_loader(DataConfig(**DATA), device="cpu"),
                       log=None)
        assert state["step"] == STEPS
        runs.append((tr, {"params": [p.detach().numpy() for p in state["params"]],
                          "mu": [m.numpy() for m in state["opt"]["mu"]],
                          "resid": [r.numpy() for r in state["comp"]]}))
    return rtr, want, runs


@pytest.mark.parametrize("name", ["fp8wire", "efsignsgd"])
def test_trainer_flat_wire_matches_reference(name):
    """``TrainConfig(compressor=name)`` through ``Trainer.run``, with and
    without the arena, against the reference trainer over 5 SGD steps:
    losses at rtol 1e-5, grad norms at rtol 1e-4, params, momenta and EF
    residuals within ``assert_quantized_wire_close``'s allowance (one
    framework's last-bit gradient differences flip some fp8 codes or signs,
    and the runs drift apart from there); the arena run equals the
    per-bucket run bit for bit.  ``python tests/test_torch_trainer.py``
    prints the drift."""
    from _torch_dist_worker import assert_quantized_wire_close

    rtr, want, runs = _flat_wire_runs(name)
    mu_max = max(float(np.max(np.abs(x))) for x in want["mu"])
    for arena, (tr, got) in zip((False, True), runs):
        assert tr.num_phases == 1 and tr.compressor.name == name
        assert tr.schedule_report() == rtr.schedule_report()
        np.testing.assert_allclose([h["loss"] for h in tr.history],
                                   [h["loss"] for h in rtr.history], rtol=1e-5)
        np.testing.assert_allclose([h["grad_norm"] for h in tr.history],
                                   [h["grad_norm"] for h in rtr.history], rtol=1e-4)
        for part in got:
            assert_quantized_wire_close(part, got[part], want[part], steps=STEPS,
                                        lr=LR, mu_max=mu_max,
                                        err_msg=f"{name} arena={arena} {part}")
    (_, plain), (_, arena) = runs
    assert all(np.array_equal(a, b) for part in plain
               for a, b in zip(plain[part], arena[part]))


def _powersgd_runs(compressor_options):
    """The reference trainer and the port's over 5 SGD steps of
    ``compressor="powersgd"`` from the same parameters and the same
    starting Q (the reference's, carried over by
    ``interop.compressor_state_from_jax``).  -> ``(reference trainer, port
    trainer, {part: (port leaves, reference leaves)})`` for params, SGD's
    momenta, residuals and Q, as numpy arrays."""
    tc = dict(TC, compressor="powersgd", compressor_options=compressor_options)
    rtr = RTrainer(r_build_model(rconfigs.get_reduced("gpt2-paper")),
                   r_sgd(LR, momentum=0.9), RTrainConfig(**tc))
    rstate = rtr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, rstate["params"])
    comp0 = {k: [None if v is None else np.asarray(v) for v in vs]
             for k, vs in rstate["comp"].items()}
    rstate = rtr.run(rstate, iter(r_make_loader(RDataConfig(**DATA))), log=None)
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu")
    model.load_state_dict(params_from_jax(init, device="cpu"))
    tr = Trainer(model, sgd(LR, momentum=0.9), TrainConfig(**tc))
    state = tr.init_state()
    state["comp"] = compressor_state_from_jax(comp0, device="cpu")
    state = tr.run(state, make_loader(DataConfig(**DATA), device="cpu"), log=None)
    assert state["step"] == STEPS

    def present(xs):
        return [np.asarray(x) for x in xs if x is not None]

    parts = {
        "params": ([p.detach().numpy() for p in state["params"]],
                   present(jax.tree_util.tree_leaves(rstate["params"]))),
        "mu": ([m.numpy() for m in state["opt"]["mu"]],
               present(jax.tree_util.tree_leaves(rstate["opt"]["mu"]))),
        "resid": (present(state["comp"]["residual"]), present(rstate["comp"]["residual"])),
        "q": (present(state["comp"]["q"]), present(rstate["comp"]["q"])),
    }
    return rtr, tr, parts


@pytest.mark.parametrize("options", [{}, {"ef": False}, {"rank": 4}],
                         ids=["defaults", "no-ef", "rank-4"])
def test_trainer_powersgd_matches_reference(options):
    """``TrainConfig(compressor="powersgd")`` through ``Trainer.run`` against
    the reference trainer over 5 SGD steps.  Q is warm-started from step to
    step, so the frameworks' last-bit differences in P pass through QR into
    the next step: after 5 steps momenta, residuals and Q differ by up to 8e-6
    of their largest values (``python tests/test_torch_trainer.py`` prints
    the drift).  Held at: losses and grad norms rtol 1e-5; params at the
    float32 bound (rtol 1e-4, atol 1e-6); momenta, residuals and Q at rtol
    1e-4, atol 1e-4 of the part's largest reference value."""
    rtr, tr, parts = _powersgd_runs(options)
    assert tr.num_phases == 1 and tr.compressor.name == "powersgd"
    assert tr.schedule_report() == rtr.schedule_report()
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in rtr.history], rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in tr.history],
                               [h["grad_norm"] for h in rtr.history], rtol=1e-5)
    n_resid = 0 if options.get("ef") is False else 12
    assert len(parts["resid"][0]) == len(parts["resid"][1]) == n_resid
    for part, (got, want) in parts.items():
        assert len(got) == len(want)
        if not want:
            continue
        scale = max(float(np.max(np.abs(w))) for w in want)
        rtol, atol = (1e-4, 1e-6) if part == "params" else (1e-4, 1e-4 * scale)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"{part} {i}")


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50])
def test_cosine_warmup_matches_reference(step):
    assert float(cosine_warmup(1.5e-4, 2, 10)(step)) == pytest.approx(
        float(r_cosine_warmup(1.5e-4, 2, 10)(step)), rel=1e-6
    )


def test_unported_train_options_raise():
    """``arena=True``, ``sync="sharded"`` and ``overlap="fused"`` are ported
    and accepted.  ``TrainConfig.interval`` stays an integer, as in the
    reference: ``interval="auto"`` raises and points to
    ``api.resolve_interval``, which resolves it (``api.fit`` and the CLI
    call it first).  An unknown overlap and an unknown compressor raise;
    ``topk`` is ported."""
    from repro_torch.train.trainer import make_compressor

    tc = TrainConfig(arena=True, sync="sharded", overlap="fused")
    comp = make_compressor(tc)
    assert comp._arena_on() and comp.sync_mode == "sharded" and tc.overlap == "fused"
    with pytest.raises(ValueError, match="resolve_interval"):
        TrainConfig(interval="auto")
    with pytest.raises(ValueError, match="overlap"):
        TrainConfig(overlap="inline")
    assert make_compressor(TrainConfig(compressor="topk")).name == "topk"
    with pytest.raises(KeyError):
        make_compressor(TrainConfig(compressor="qsgd"))


def test_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "2", "--seq-len", "16", "--global-batch", "4",
         "--device", "cpu", "--log-every", "1"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    for tag in ("[plan] 1 buckets", "[schedule] mean", "[model] gpt2-paper",
                "step     1  loss", "step     2  loss", "[done]"):
        assert tag in out, out


def test_cli_runs_powersgd_on_cpu():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--compressor", "powersgd", "--steps", "2", "--seq-len", "16",
         "--global-batch", "4", "--device", "cpu", "--log-every", "1"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    # 47,648 bytes a step at REDUCED: 12 leaf all-reduces of rank-2 factors
    for tag in ("1 phase executable(s)", "[schedule] mean 0.048 MB/step",
                "step     1  loss", "step     2  loss", "[done]"):
        assert tag in out, out


@pytest.mark.parametrize("compressor", ["fp8wire", "efsignsgd"])
def test_cli_runs_flat_wires_on_cpu(compressor):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--compressor", compressor, "--arena", "--steps", "2", "--seq-len", "16",
         "--global-batch", "4", "--device", "cpu", "--log-every", "1"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    for tag in ("[plan] 1 buckets, target", "1 phase executable(s)",
                "[schedule] mean", "step     1  loss", "step     2  loss", "[done]"):
        assert tag in out, out


def test_cli_interval_auto_raises():
    """``--interval auto`` no longer raises: it resolves the paper's ``I =
    ceil(CCR)`` as the reference's CLI does and prints its ``[ccr]`` line
    (the same interval as ``repro.launch.train``: 64 at REDUCED with the
    default 8 modelled workers), here with ``--overlap fused``."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--interval", "auto", "--overlap", "fused", "--steps", "2",
         "--seq-len", "16", "--global-batch", "4", "--device", "cpu",
         "--log-every", "1"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    for tag in ("[ccr] analytic CCR=2552.08 -> interval I=64",
                "64 phase executable(s)", "step     2  loss", "[done]"):
        assert tag in out, out


if __name__ == "__main__":
    # the drift of the quantizing wires from the reference, one worker
    from _torch_dist_worker import wire_drift

    for wire in ("fp8wire", "efsignsgd"):
        _, want, runs = _flat_wire_runs(wire)
        for part in ("params", "mu", "resid"):
            print(wire, part, wire_drift(runs[0][1][part], want[part]))
    # PowerSGD's drift, each part's largest difference over its largest value
    _, _, parts = _powersgd_runs({})
    for part, (got, want) in parts.items():
        drift = wire_drift(got, want)
        print("powersgd", part, drift, drift["max"] / drift["max_want"])
