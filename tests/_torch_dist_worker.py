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
