"""Workers of the port's multi-process gloo tests (``test_torch_multiworker.py``,
``test_torch_sharded.py``, ``test_torch_checkpoint.py``,
``test_torch_sparsify.py``).

It imports only torch, numpy and ``repro_torch``, so spawned processes start
without JAX.  Each rank trains the REDUCED gpt2-paper once per entry of
``runs`` (``name -> TrainConfig kwargs``), every time from the parameters in
``init_npz``, on its contiguous rows of the global batch (the split the
reference's data axis makes), in one gloo group.  It writes every run's
losses, grad norms, params, EF residuals and params-shaped optimizer state
(SGD's ``mu``, Adam's ``m`` and ``v``; after ``run``'s flush) to
``<out_prefix><rank>.npz`` under ``<name>/...`` keys, and the last step's
head all-gather events (sharded sync) under ``trace/<name>/gather_events``
and the order its hooks fired in (``overlap="fused"``) under
``trace/<name>/fired``.  A run whose
compressor state is PowerSGD's (``{"q", "residual"}``) starts from the Q in
``init_comp_npz`` (``<name>/q:<leaf index>`` keys) and writes its residuals
and Q under ``<name>/resid:<leaf index>`` and ``<name>/q:<leaf index>``.
"""
import numpy as np
import torch
import torch.distributed as dist


def _leaf_state(name, init_comp_npz, n_leaves):
    """The starting Q of run ``name``, in leaf order (``None`` where a leaf
    has none), as PowerSGD's state takes it."""
    from repro_torch.interop import compressor_state_from_jax

    with np.load(init_comp_npz) as init:
        qs = [init[f"{name}/q:{i}"] if f"{name}/q:{i}" in init.files else None
              for i in range(n_leaves)]
    return compressor_state_from_jax({"q": qs}, device="cpu")["q"]


def train_worker(rank, world, init_file, init_npz, out_prefix, runs, data_kw,
                 optimizer, lr, steps, init_comp_npz=None):
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
            state = tr.init_state()
            leaf_state = isinstance(state["comp"], dict)
            if leaf_state:
                state["comp"]["q"] = _leaf_state(name, init_comp_npz,
                                                 len(state["params"]))
            state = tr.run(state, batches, steps=steps, log=None)
            out[f"{name}/losses"] = np.array([h["loss"] for h in tr.history])
            out[f"{name}/grad_norm"] = np.array([h["grad_norm"] for h in tr.history])
            out[f"trace/{name}/gather_events"] = np.array(
                [(EVENT_KINDS.index(k), i) for k, i in tr.gather_events], np.int64)
            out[f"trace/{name}/fired"] = np.array(tr.last_step_fn.fired, np.int64)
            parts = {"params": state["params"]}
            if leaf_state:
                for part, key in (("resid", "residual"), ("q", "q")):
                    for i, x in enumerate(state["comp"][key]):
                        if x is not None:
                            out[f"{name}/{part}:{i}"] = x.numpy().copy()
            else:
                parts["resid"] = state["comp"]
            parts.update((k, v) for k, v in state["opt"].items()
                         if isinstance(v, list) and len(v) == len(state["params"]))
            for part, leaves in parts.items():
                for (path, _), x in zip(model.named_leaves(), leaves):
                    out[f"{name}/{part}:{path}"] = x.detach().numpy().copy()
        np.savez(f"{out_prefix}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


EVENT_KINDS = ("issue", "settle", "layer")


def gather_worker(rank, world, init_file, init_npz, out_prefix, tc_kw, data_kw, lr,
                  steps):
    """Sharded sync two ways from the same parameters, ``steps`` AdamW steps
    each: ``async/`` through ``Trainer.step`` (the head all-gather started
    per bucket and waited for where the forward pass first reads the
    bucket), ``blocking/`` through the same per-phase step functions' parts
    with the blocking ``sharded_param_allgather`` before the forward pass.
    Writes each run's losses, and its params, Adam moments and residuals
    before (``<run>/pre/...``) and after (``<run>/post/...``) a final
    blocking gather of params and moments, and every step's head-gather
    events of the async run as ``events:<step>``, ``(kind, index)`` rows
    with ``kind`` an index of ``EVENT_KINDS``."""
    from repro_torch import optim
    from repro_torch.configs import get_reduced
    from repro_torch.core.overlap import sharded_param_allgather
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer, build_step_fn, loss_and_grads

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        group = dist.group.WORLD
        loader = make_loader(DataConfig(**data_kw), device="cpu")
        local = data_kw["global_batch"] // world
        rows = slice(rank * local, (rank + 1) * local)
        batches = [{k: v[rows] for k, v in loader.make(s).items()} for s in range(steps)]

        def trainer():
            model = build_model(get_reduced("gpt2-paper"), device="cpu")
            with np.load(init_npz) as init:
                model.load_state_dict({k: torch.from_numpy(init[k]) for k in init.files})
            tr = Trainer(model, optim.adamw(lr), TrainConfig(**tc_kw), group=group)
            return tr, tr.init_state()

        out = {}
        tr, state = trainer()
        losses = []
        for s, batch in enumerate(batches):
            state, metrics = tr.step(state, batch)
            losses.append(float(metrics["loss"]))
            out[f"events:{s}"] = np.array(
                [(EVENT_KINDS.index(k), i) for k, i in tr.gather_events], np.int64)
        runs = {"async": (tr, state, losses)}

        tr_b, state_b = trainer()
        fns, losses_b = {}, []
        for s, batch in enumerate(batches):
            phase = s % tr_b.num_phases
            if phase not in fns:
                fns[phase] = build_step_fn(tr_b.model, tr_b.optimizer, tr_b.compressor,
                                           tr_b.plan, phase=phase, group=group)
            sharded_param_allgather(tr_b.compressor, fns[phase].comm_schedule,
                                    state_b["params"], group=group)
            grads, metrics = loss_and_grads(tr_b.model, state_b["params"], batch, group)
            losses_b.append(float(metrics["loss"]))
            state_b, _ = fns[phase].update(state_b, grads)
        runs["blocking"] = (tr_b, state_b, losses_b)

        for name, (t, st, ls) in runs.items():
            out[f"{name}/losses"] = np.array(ls)
            sched = t.compressor.plan_phase(t.plan, 0, world=world)
            for when in ("pre", "post"):
                if when == "post":
                    for tree in (st["params"], st["opt"]["m"], st["opt"]["v"]):
                        sharded_param_allgather(t.compressor, sched, tree, group=group)
                parts = {"params": st["params"], "m": st["opt"]["m"],
                         "v": st["opt"]["v"], "resid": st["comp"]}
                for part, leaves in parts.items():
                    for (path, _), x in zip(t.model.named_leaves(), leaves):
                        out[f"{name}/{when}/{part}:{path}"] = x.detach().numpy().copy()
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


def ckpt_worker(rank, world, init_file, init_npz, ckpt_dir, out_prefix, tc_kw,
                data_kw, lr, steps_before, steps_after):
    """Checkpoint and resume on ``world`` gloo workers, AdamW from the
    parameters in ``init_npz``: run ``A`` trains ``steps_before`` steps,
    saves with ``checkpoint.save_train_state`` (every rank's comp state)
    and trains ``steps_after`` more; run ``B`` restores into a fresh
    trainer and trains the same ``steps_after`` batches.  Writes, under
    ``A/`` and ``B/``, the params, Adam moments, residuals and both steps,
    and the residuals as saved (``saved/``) and as restored
    (``restored/``), and the params as saved (``saved_params/``), to
    ``<out_prefix><rank>.npz``."""
    from repro_torch import checkpoint, optim
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        group = dist.group.WORLD
        loader = make_loader(DataConfig(**data_kw), device="cpu")
        local = data_kw["global_batch"] // world
        rows = slice(rank * local, (rank + 1) * local)
        batches = [{k: v[rows] for k, v in loader.make(s).items()}
                   for s in range(steps_before + steps_after)]

        def trainer():
            model = build_model(get_reduced("gpt2-paper"), device="cpu")
            with np.load(init_npz) as init:
                model.load_state_dict({k: torch.from_numpy(init[k]) for k in init.files})
            tr = Trainer(model, optim.adamw(lr), TrainConfig(**tc_kw), group=group)
            return tr, tr.init_state()

        def record(tag, tr, state):
            parts = {"params": state["params"], "m": state["opt"]["m"],
                     "v": state["opt"]["v"], "resid": state["comp"]}
            for part, leaves in parts.items():
                for path, x in zip(tr.leaf_names, leaves):
                    out[f"{tag}/{part}:{path}"] = x.detach().numpy().copy()
            out[f"{tag}/step"] = np.array([state["step"], state["opt"]["step"]])

        out = {}
        tr, state = trainer()
        state = tr.run(state, iter(batches[:steps_before]), steps=steps_before,
                       log=None)
        checkpoint.save_train_state(ckpt_dir, state, interval=tr.tc.interval,
                                    names=tr.leaf_names, group=group)
        for path, x, p in zip(tr.leaf_names, state["comp"], state["params"]):
            out[f"saved/{path}"] = x.numpy().copy()
            out[f"saved_params/{path}"] = p.detach().numpy().copy()
        state = tr.run(state, iter(batches[steps_before:]), steps=steps_after, log=None)
        record("A", tr, state)

        tr, state = trainer()
        state, extra = checkpoint.restore_train_state(ckpt_dir, state,
                                                      names=tr.leaf_names, group=group)
        assert extra["comp_restored"] and extra["world"] == world, extra
        for path, x in zip(tr.leaf_names, state["comp"]):
            out[f"restored/{path}"] = x.numpy().copy()
        state = tr.run(state, iter(batches[steps_before:]), steps=steps_after, log=None)
        record("B", tr, state)
        np.savez(f"{out_prefix}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def sparse_worker(rank, world, init_file, in_npz, out_prefix, ratio):
    """Each rank's flat vector ``x<rank>`` of ``in_npz`` through the
    sparsifying wire stages (``TopK``, ``RandomK`` with the key of seed 0,
    step 3, bucket 1, and ``OkTopKRoute``) in one gloo group; writes each
    stage's synced and sent vectors, and RandomK's indices, to
    ``<out_prefix><rank>.npz``."""
    from repro_torch.core.stages import BucketKey, OkTopKRoute, RandomK, TopK

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        group = dist.group.WORLD
        with np.load(in_npz) as data:
            x = torch.from_numpy(data[f"x{rank}"])
        key = BucketKey(0, 3, 1)
        out = {"randomk/idx": RandomK(ratio).indices(key, x.numel(), x.device).numpy()}
        for name, stage in (("topk", TopK(ratio)), ("randomk", RandomK(ratio)),
                            ("oktopk", OkTopKRoute(ratio))):
            synced, sent = stage.execute_bucket(x.clone(), key, group)
            out[f"{name}/synced"] = synced.numpy()
            out[f"{name}/sent"] = sent.numpy()
        np.savez(f"{out_prefix}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
