"""Worker of the port's two-process gloo tests (``test_torch_multiworker.py``,
``test_torch_sharded.py``).

It imports only torch, numpy and ``repro_torch``, so spawned processes start
without JAX.  Each rank trains the REDUCED gpt2-paper once per entry of
``runs`` (``name -> TrainConfig kwargs``), every time from the parameters in
``init_npz``, on its contiguous rows of the global batch (the split the
reference's data axis makes), in one gloo group.  It writes every run's
losses, grad norms, params, EF residuals and params-shaped optimizer state
(SGD's ``mu``, Adam's ``m`` and ``v``; after ``run``'s flush) to
``<out_prefix><rank>.npz`` under ``<name>/...`` keys.
"""
import numpy as np
import torch
import torch.distributed as dist


def train_worker(rank, world, init_file, init_npz, out_prefix, runs, data_kw,
                 optimizer, lr, steps):
    from repro_torch import optim
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        out = {}
        loader = make_loader(DataConfig(**data_kw), device="cpu")
        local = data_kw["global_batch"] // world
        rows = slice(rank * local, (rank + 1) * local)
        for name, tc_kw in runs.items():
            model = build_model(get_reduced("gpt2-paper"), device="cpu")
            with np.load(init_npz) as init:
                model.load_state_dict(
                    {k: torch.from_numpy(init[k]) for k in init.files})
            opt = (optim.sgd(lr, momentum=0.9) if optimizer == "sgd"
                   else optim.adamw(lr))
            tr = Trainer(model, opt, TrainConfig(**tc_kw), group=dist.group.WORLD)
            batches = ({k: v[rows] for k, v in loader.make(s).items()}
                       for s in range(steps))
            state = tr.run(tr.init_state(), batches, steps=steps, log=None)
            out[f"{name}/losses"] = np.array([h["loss"] for h in tr.history])
            out[f"{name}/grad_norm"] = np.array([h["grad_norm"] for h in tr.history])
            parts = {"params": state["params"], "resid": state["comp"]}
            parts.update((k, v) for k, v in state["opt"].items()
                         if isinstance(v, list) and len(v) == len(state["params"]))
            for part, leaves in parts.items():
                for (path, _), x in zip(model.named_leaves(), leaves):
                    out[f"{name}/{part}:{path}"] = x.detach().numpy().copy()
        np.savez(f"{out_prefix}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def wire_drift(got, want) -> dict:
    """How far a part's leaves lie from the reference's: the elements
    outside the float32 bound (rtol 1e-4, atol 1e-6), the element count,
    the L2 norm of the difference over the reference's, and the largest
    difference."""
    d = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    w = np.concatenate([np.asarray(x).ravel() for x in want])
    return {"over": int((d > 1e-6 + 1e-4 * np.abs(w)).sum()), "size": int(w.size),
            "rel_l2": float(np.linalg.norm(d) / np.linalg.norm(w)),
            "max": float(d.max()), "max_want": float(np.abs(w).max())}


def assert_quantized_wire_close(part, got, want, *, steps, lr, mu_max,
                                err_msg=""):
    """The allowance of the port's tests for a run through a quantizing wire
    (``fp8wire``, ``efsignsgd``) held against the reference's run.

    ``got`` and ``want`` are the leaves of one part (``"params"``, ``"mu"``
    for SGD's momenta, ``"resid"``) as numpy arrays; ``mu_max`` is the
    largest reference momentum.  The two frameworks' gradients differ in
    their last bits, and the reference's jit rounds an fp8 scale as
    ``amax * (1/448)``; where that puts a value on the other side of an fp8
    rounding boundary, or a value near 0 on the other side of 0, the wire
    sends another code, and the runs drift apart from there.  So:

    * params: at most 1/200 of the elements outside the float32 bound
      (rtol 1e-4, atol 1e-6), each within ``lr * steps * mu_max``;
    * momenta: at most 1/20 outside that bound, each within ``mu_max``;
    * residuals, the wire's rounding error, which a flipped code moves by a
      whole step: the difference's L2 norm within a quarter of the
      reference's, each element within twice the largest reference
      residual.
    """
    drift = wire_drift(got, want)
    if part == "resid":
        assert drift["rel_l2"] <= 0.25, (err_msg, drift)
        assert drift["max"] <= 2 * drift["max_want"], (err_msg, drift)
        return
    share, bound = {"params": (1 / 200, lr * steps * mu_max),
                    "mu": (1 / 20, mu_max)}[part]
    assert drift["over"] <= share * drift["size"], (err_msg, drift)
    assert drift["max"] <= bound, (err_msg, drift, bound)
