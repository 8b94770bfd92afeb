"""Workers of the port's multi-process gloo tests (``test_torch_multiworker.py``,
``test_torch_sharded.py``, ``test_torch_checkpoint.py``,
``test_torch_sparsify.py``, ``test_torch_resilience.py``,
``test_torch_hierarchical.py``, ``test_torch_launch.py``).  ``adaptive_worker``
runs the adaptive runtime on every rank; ``chaos_worker`` and
``residual_fault_worker`` the resilience runtime; ``hier_worker`` hierarchical
pods; ``fit_worker`` ``api.fit(group=)``.

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


def adaptive_worker(rank, world, init_file, out_prefix, tc_kw, data_kw, lr, steps,
                    ccrs):
    """The adaptive runtime on ``world`` gloo workers, SGD from the model of
    seed 0, ``steps`` steps on each rank's rows, three runs:

    * ``skew``: a synthetic probe that reports ``ccrs[rank]``, so that the
      ranks' own CCRs fall on either side of a band edge;
    * ``real``: the real ``PhaseProbe`` on every step (the schedule-only
      program's all-reduces on the group), never re-planning;
    * ``static``: ``autotune=None``.

    Writes each run's final interval, re-plan steps, the ``(t_full,
    t_comp, t_comm)`` of every sample the controller saw, the decisions'
    measured CCRs, and the params and residuals, to
    ``<out_prefix><rank>.npz``."""
    from repro_torch import optim
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.models import build_model
    from repro_torch.runtime import AutotuneConfig, synthetic_probe
    from repro_torch.train import TrainConfig, Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        loader = make_loader(DataConfig(**data_kw), device="cpu")
        local = data_kw["global_batch"] // world
        rows = slice(rank * local, (rank + 1) * local)
        runs = {
            "skew": AutotuneConfig(measure_every=1, warmup_steps=1, window=1, patience=1,
                                   cooldown_steps=0,
                                   probe=synthetic_probe(0.01, ccrs[rank])),
            "real": AutotuneConfig(measure_every=1, warmup_steps=0, max_replans=0,
                                   probe_warmup=1, probe_iters=1),
            "static": None,
        }
        out = {}
        for name, autotune in runs.items():
            model = build_model(get_reduced("gpt2-paper"), device="cpu", seed=0)
            tr = Trainer(model, optim.sgd(lr, momentum=0.9), TrainConfig(**tc_kw),
                         group=dist.group.WORLD)
            batches = ({k: v[rows] for k, v in loader.make(s).items()}
                       for s in range(steps))
            state = tr.run(tr.init_state(), batches, steps=steps, log=None,
                           autotune=autotune)
            out[f"{name}/interval"] = np.array(tr.tc.interval)
            if tr.runtime is not None:
                ctrl = tr.runtime.controller
                out[f"{name}/replan_steps"] = np.array(ctrl.replan_steps, np.int64)
                out[f"{name}/measured_ccr"] = np.array(
                    [d.measured_ccr for d in ctrl.decisions], np.float64)
                out[f"{name}/samples"] = np.array(
                    [(s.t_full, s.t_comp, s.t_comm) for s in tr.runtime.monitor.samples()],
                    np.float64)
            for part, leaves in (("params", state["params"]), ("resid", state["comp"])):
                for path, x in zip(tr.leaf_names, leaves):
                    out[f"{name}/{part}:{path}"] = x.detach().numpy().copy()
        np.savez(f"{out_prefix}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _write_chaos(out_prefix, rank, params, meta):
    import json

    np.savez(f"{out_prefix}{rank}.npz",
             **{f"p{i}": p.detach().numpy() for i, p in enumerate(params)})
    with open(f"{out_prefix}{rank}.json", "w") as f:
        json.dump(meta, f)


def chaos_worker(rank, world, init_file, td, out_prefix):
    """The chaos gate's scenario (``repro_torch.launch.chaos_gate.run_chaos``,
    REDUCED, covap ``I=2``) on ``world`` gloo workers, the checkpoints
    shared under ``td``.  Writes the final
    params to ``<out_prefix><rank>.npz`` and the trips, actions, final
    step, loss, summary and the gate's verdict to ``<out_prefix><rank>.json``."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import chaos_gate

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        cfg = get_reduced("gpt2-paper").with_(vocab_size=chaos_gate.REDUCED_DATA["vocab_size"])
        out = chaos_gate.run_chaos(
            td, cfg, device="cpu", group=dist.group.WORLD,
            seq_len=chaos_gate.REDUCED_DATA["seq_len"], global_batch=world,
            corpus_tokens=chaos_gate.REDUCED_DATA["corpus_tokens"],
            tc_kw=chaos_gate.REDUCED_TC)
        _write_chaos(out_prefix, rank, out["state"]["params"],
                     {k: out[k] for k in ("trips", "actions", "final_step", "loss",
                                          "summary", "resumed_from")}
                     | {"passed": chaos_gate.passed(out)})
    finally:
        dist.destroy_process_group()


def residual_fault_worker(rank, world, init_file, td, out_prefix, spec, agree, steps,
                          interval):
    """``steps`` iterations of the chaos gate's trainer (REDUCED, covap at
    ``interval``, AdamW) under guards (lag-one, the residual watchdog every 2
    steps, no checkpoints) with ``spec[rank]`` as this rank's faults.
    ``agree=False`` replaces the runtime's maximum of the residual norms
    over the group by this rank's own norm.  Writes as
    :func:`chaos_worker`."""
    from repro_torch.api import _worker_batches
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig
    from repro_torch.launch import chaos_gate
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.resilience import recovery
    from repro_torch.train import TrainConfig, Trainer

    torch.set_num_threads(1)
    if not agree:
        recovery._group_max = lambda values, group: None
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        data = chaos_gate.REDUCED_DATA
        model = build_model(get_reduced("gpt2-paper").with_(vocab_size=data["vocab_size"]),
                            device="cpu", seed=0)
        tr = Trainer(model, adamw(chaos_gate.LR),
                     TrainConfig(compressor="covap", interval=interval, log_every=1000,
                                 **chaos_gate.REDUCED_TC),
                     group=dist.group.WORLD)
        loader = _worker_batches(DataConfig(global_batch=world, **data), "cpu",
                                 dist.group.WORLD)
        guards = {k: v for k, v in chaos_gate.GUARDS.items() if k != "ckpt_every"}
        state = tr.run(tr.init_state(), loader, steps=steps, log=None, guards=guards,
                       faults=spec[rank])
        rt = tr.resilience
        _write_chaos(out_prefix, rank, state["params"],
                     {"trips": [(t.step, t.guard) for t in rt.guards.trips],
                      "actions": rt.actions, "final_step": state["step"]})
    finally:
        dist.destroy_process_group()


def sharded_skip_worker(rank, world, init_file, td, out_prefix, tc_kw, steps, fault_step):
    """Skip-step under ``tc_kw`` (sharded sync) on ``world`` gloo workers:
    ``grad_nan@<fault_step>`` with lag-one guards over ``steps`` global
    batches, then a clean run over the same batches without the poisoned
    one and the detection step's.  Writes both runs' params, Adam moments
    and residuals (after ``run``'s flush) under ``healed/`` and ``replay/``
    keys and their steps to ``<out_prefix><rank>.npz``."""
    from repro_torch.api import _worker_batches
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        cfg = get_reduced("gpt2-paper").with_(vocab_size=256)
        dc = DataConfig(vocab_size=256, seq_len=16, global_batch=2 * world,
                        corpus_tokens=1 << 12)
        it = _worker_batches(dc, "cpu", dist.group.WORLD)
        batches = [next(it) for _ in range(steps)]
        keep = batches[:fault_step] + batches[fault_step + 2:]
        out = {}
        for name, run_batches, kw in (
                ("healed", batches, dict(guards={"sync_every": 1},
                                         faults=f"grad_nan@{fault_step}")),
                ("replay", keep, {})):
            tr = Trainer(build_model(cfg, device="cpu", seed=0), adamw(3e-3),
                         TrainConfig(**tc_kw), group=dist.group.WORLD)
            state = tr.run(tr.init_state(), iter(run_batches), steps=len(run_batches),
                           log=None, **kw)
            _dump_state(out, name, tr, state)
        np.savez(f"{out_prefix}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _dump_state(out, name, tr, state):
    out[f"{name}/step"] = np.array(state["step"])
    for part, leaves in (("p", state["params"]), ("m", state["opt"]["m"]),
                         ("v", state["opt"]["v"]), ("r", state["comp"])):
        for i, x in enumerate(leaves):
            out[f"{name}/{part}{i}"] = x.detach().numpy().copy()
    if tr.resilience is not None:
        out[f"{name}/actions"] = np.array([a["action"] for a in tr.resilience.actions])


def sharded_replan_skip_worker(rank, world, init_file, td, out_prefix, tc_kw, steps):
    """Skip-step across a re-plan under ``tc_kw`` (sharded sync, covap at
    ``I=4``) on ``world`` gloo workers, guards with ``sync_every=2``: the
    window opening at step 2 is copied while step 1's head all-gather is
    pending; a synthetic probe (CCR 0.5, read from step 3 on) re-plans to
    ``I=1`` after step 3; ``grad_nan@3`` trips, read at iteration 5, and
    rolls back to that copy.  Then the clean run: steps 0-1 under ``I=4``,
    ``replan(1)``, and the batches the healed run trained on after its
    recovery.  Writes both as :func:`sharded_skip_worker` does, with the
    healed run's transitions."""
    from repro_torch.api import _worker_batches
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import AutotuneConfig, synthetic_probe
    from repro_torch.train import TrainConfig, Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        cfg = get_reduced("gpt2-paper").with_(vocab_size=256)
        dc = DataConfig(vocab_size=256, seq_len=16, global_batch=2 * world,
                        corpus_tokens=1 << 12)
        it = _worker_batches(dc, "cpu", dist.group.WORLD)
        batches = [next(it) for _ in range(steps)]

        def trainer():
            tr = Trainer(build_model(cfg, device="cpu", seed=0), adamw(3e-3),
                         TrainConfig(**tc_kw, interval=4), group=dist.group.WORLD)
            return tr, tr.init_state()

        out = {}
        tr, state = trainer()
        probe = synthetic_probe(0.01, 0.5)
        state = tr.run(state, iter(batches), steps=steps, log=None,
                       guards={"sync_every": 2}, faults="grad_nan@3",
                       autotune=AutotuneConfig(probe=probe, measure_every=1,
                                               warmup_steps=3, window=1, patience=1,
                                               cooldown_steps=0))
        _dump_state(out, "healed", tr, state)
        out["healed/transitions"] = np.array(
            [(r.step, r.old_interval, r.new_interval) for r in tr.transitions])
        out["healed/policies"] = np.array([r.policy for r in tr.transitions])
        tr, state = trainer()
        state = tr.run(state, iter(batches[:2]), steps=2, log=None)
        state, _ = tr.replan(1, state)
        state = tr.run(state, iter(batches[5:]), steps=steps - 5, log=None)
        _dump_state(out, "replay", tr, state)
        np.savez(f"{out_prefix}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def hier_worker(rank, world, init_file, init_npz, out_prefix, n_pods, runs, data_kw,
                lr, steps):
    """Hierarchical pods: every rank trains REDUCED gpt2-paper (its vocab
    from ``data_kw``) once per entry of ``runs`` (``name -> (optimizer,
    TrainConfig kwargs)``, optimizer ``"sgd"`` with momentum 0.9 or
    ``"adam"``) from the parameters in ``init_npz``, in the groups of
    ``launch.mesh.build_groups(n_pods)``, on its contiguous rows (by world
    rank) of every global batch.  Writes each run's losses, params,
    residuals and params-shaped optimizer state (after ``run``'s flush)
    under ``<name>/<part>:<path>`` keys, and the rank's pod as ``pod``."""
    from repro_torch import optim
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.launch.mesh import build_groups
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        groups = build_groups(n_pods)
        loader = make_loader(DataConfig(**data_kw), device="cpu")
        local = data_kw["global_batch"] // world
        rows = slice(rank * local, (rank + 1) * local)
        cfg = get_reduced("gpt2-paper").with_(vocab_size=data_kw["vocab_size"])
        out = {"pod": np.array(groups.pod)}
        for name, (optimizer, tc_kw) in runs.items():
            model = build_model(cfg, device="cpu")
            with np.load(init_npz) as init:
                model.load_state_dict({k: torch.from_numpy(init[k]) for k in init.files})
            opt = (optim.sgd(lr, momentum=0.9) if optimizer == "sgd"
                   else optim.adamw(lr))
            tr = Trainer(model, opt, TrainConfig(**tc_kw),
                         group=groups.intra, pod_group=groups.cross)
            assert tr.hierarchical
            batches = ({k: v[rows] for k, v in loader.make(s).items()}
                       for s in range(steps))
            state = tr.run(tr.init_state(), batches, steps=steps, log=None)
            out[f"{name}/losses"] = np.array([h["loss"] for h in tr.history])
            parts = {"params": state["params"], "resid": state["comp"]}
            parts.update((k, v) for k, v in state["opt"].items()
                         if isinstance(v, list) and len(v) == len(state["params"]))
            for part, leaves in parts.items():
                for (path, _), x in zip(model.named_leaves(), leaves):
                    out[f"{name}/{part}:{path}"] = x.detach().numpy().copy()
        np.savez(f"{out_prefix}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def fit_worker(rank, world, init_file, out_prefix, fit_kw):
    """``api.fit(group=WORLD, device="cpu", **fit_kw)`` on every rank; writes
    the history's losses and steps."""
    from repro_torch import api

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        r = api.fit(group=dist.group.WORLD, device="cpu", **fit_kw)
        np.savez(f"{out_prefix}{rank}.npz",
                 losses=np.array([h["loss"] for h in r.history]),
                 steps=np.array([h["step"] for h in r.history]))
    finally:
        dist.destroy_process_group()


def hier_resume_worker(rank, world, init_file, ckpt_dir, out_prefix, n_pods, tc_kw,
                       data_kw, lr, steps, split):
    """Hierarchical pods through checkpoint, guards and a re-plan, on every
    rank (SGD, REDUCED gpt2-paper at ``data_kw``'s vocab, seed 0):
    ``whole/`` trains ``steps`` steps; ``resumed/`` trains ``split``, saves
    with ``shared=False`` (the pods' params differ), restores into a fresh
    trainer and trains the rest on the same batches; ``guarded/`` trains
    under ``guards=True`` with a ``grad_nan`` at ``split`` until ``steps``
    are committed; ``replan/`` re-plans to ``I = 1`` after ``split`` steps
    and trains one more.  Writes params and residuals by run, and each
    guarded run's committed step, trips and actions."""
    from repro_torch import checkpoint, optim
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.launch.mesh import build_groups
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        groups = build_groups(n_pods)
        loader = make_loader(DataConfig(**data_kw), device="cpu")
        local = data_kw["global_batch"] // world
        rows = slice(rank * local, (rank + 1) * local)
        batches = [{k: v[rows] for k, v in loader.make(s).items()}
                   for s in range(2 * steps)]
        cfg = get_reduced("gpt2-paper").with_(vocab_size=data_kw["vocab_size"])

        def trainer():
            tr = Trainer(build_model(cfg, device="cpu", seed=0),
                         optim.sgd(lr, momentum=0.9), TrainConfig(**tc_kw),
                         group=groups.intra, pod_group=groups.cross)
            return tr, tr.init_state()

        out = {}

        def dump(name, state):
            for part, leaves in (("params", state["params"]), ("resid", state["comp"]),
                                 ("mu", state["opt"]["mu"])):
                for i, x in enumerate(leaves):
                    out[f"{name}/{part}:{i}"] = x.detach().numpy().copy()

        tr, state = trainer()
        dump("whole", tr.run(state, iter(batches), steps=steps, log=None))
        tr, state = trainer()
        state = tr.run(state, iter(batches[:split]), steps=split, log=None)
        checkpoint.save_train_state(ckpt_dir, state, interval=tr.tc.interval,
                                    names=tr.leaf_names, group=tr.world_group,
                                    shared=not tr.hierarchical)
        tr, state = trainer()
        state, extra = checkpoint.restore_train_state(ckpt_dir, state, names=tr.leaf_names,
                                                      group=tr.world_group)
        assert extra["comp_restored"] and extra["per_rank"] and state["step"] == split
        dump("resumed", tr.run(state, iter(batches[split:]), steps=steps - split,
                               log=None))
        tr, state = trainer()
        it = iter(batches)
        state = tr.run(state, it, steps=steps, log=None, guards=True,
                       faults=f"grad_nan@{split}")
        while state["step"] < steps:
            state = tr.run(state, it, steps=steps - state["step"], log=None,
                           guards=tr.resilience)
        s = tr.resilience.summary()
        out["guarded/step"] = np.array(state["step"])
        out["guarded/trips"] = np.array(s["trips"])
        out["guarded/actions"] = np.array(s["actions"])
        dump("guarded", state)
        tr, state = trainer()
        state = tr.run(state, iter(batches[:split]), steps=split, log=None)
        state, rep = tr.replan(1, state, step=state["step"])
        assert tr.hierarchical and tr.num_phases == tc_kw["pod_interval"], tr.num_phases
        dump("replan", tr.run(state, iter(batches[split:]), steps=1, log=None))
        np.savez(f"{out_prefix}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def gates_worker(rank, world, init_file, out_prefix, steps):
    """The trace analysis on profiled steps of the gates' REDUCED trainer
    (``launch.overlap_gate.build_trainer``: gpt2-paper, vocabulary 256, seq
    32, global batch 8, COVAP I = 4): for each form in ``steps``
    (``name -> (build_trainer kwargs, phase)``) one step of ``phase`` under
    the profiler, and what ``hlo_analysis`` reads from its trace beside the
    plan of that phase.  Writes ``<out_prefix><rank>.json``."""
    import dataclasses
    import json

    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.launch import overlap_gate
    from repro_torch.launch.hier_gate import planned_bytes_by_link

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        out = {}
        for name, (kw, phase) in steps.items():
            tr, state, batch = overlap_gate.build_trainer(device="cpu", **kw)
            while state["step"] % tr.num_phases != phase:
                state, _ = tr.step(state, batch)
            with ha.count_collectives({tr.group: "ici"}) as (counted, unplanned):
                _, trace = overlap_gate.profile_step(tr, state, batch)
            fn = tr._phase_fn(phase)
            out[name] = {
                "plan_by_link": planned_bytes_by_link(fn),
                "plan_bytes_per_worker": fn.comm_schedule.total_bytes_per_worker,
                "counted": dict(counted), "unplanned": dict(unplanned),
                "bytes_per_worker": ha.collective_bytes_per_worker(trace, world,
                                                                   min_bytes=64),
                "bytes_by_link": ha.collective_bytes_by_link(
                    trace, intra_world=world, min_bytes=64, world=world),
                "interleave": dataclasses.asdict(ha.check_interleaving(trace)),
                "placement": dataclasses.asdict(
                    ha.check_sharded_placement(trace, world=world)),
                "data_movement": ha.count_data_movement(trace),
                "selected_segments": sum(len(tr.plan.buckets[b].segments)
                                         for b in fn.comm_schedule.selected),
                "fired": list(tr.last_step_fn.fired),
                "spans": ha.bucket_spans(trace),
                "gather_events": [list(e) for e in tr.gather_events],
            }
        with open(f"{out_prefix}{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
