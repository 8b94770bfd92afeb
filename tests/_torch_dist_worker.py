"""Worker of the port's two-process gloo test (``test_torch_multiworker.py``).

It imports only torch, numpy and ``repro_torch``, so spawned processes start
without JAX.  Each rank trains the REDUCED gpt2-paper from the parameters in
``init_npz`` on its contiguous rows of the global batch (the split the
reference's data axis makes) and writes its losses, parameters and EF
residuals to ``<out_prefix><rank>.npz``.
"""
import numpy as np
import torch
import torch.distributed as dist


def train_worker(rank, world, init_file, init_npz, out_prefix, tc_kw, data_kw,
                 lr, steps):
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.train import TrainConfig, Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        model = build_model(get_reduced("gpt2-paper"), device="cpu")
        with np.load(init_npz) as init:
            model.load_state_dict({k: torch.from_numpy(init[k]) for k in init.files})
        tr = Trainer(model, sgd(lr, momentum=0.9), TrainConfig(**tc_kw),
                     group=dist.group.WORLD)
        loader = make_loader(DataConfig(**data_kw), device="cpu")
        local = data_kw["global_batch"] // world
        rows = slice(rank * local, (rank + 1) * local)
        batches = ({k: v[rows] for k, v in loader.make(s).items()}
                   for s in range(steps))
        state = tr.run(tr.init_state(), batches, steps=steps, log=None)
        out = {"losses": np.array([h["loss"] for h in tr.history])}
        for (path, _), p, r in zip(model.named_leaves(), state["params"], state["comp"]):
            out[f"params:{path}"] = p.detach().numpy()
            out[f"resid:{path}"] = r.numpy()
        np.savez(f"{out_prefix}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
