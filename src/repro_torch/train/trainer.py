"""Data-parallel trainer: COVAP wired into the gradient synchronisation of a
``torch.distributed`` data-parallel step (``repro.train.trainer`` without
hierarchical pods).

* One step function per ``phase = step % I``: each phase's
  ``CommSchedule`` is planned when the step function is built, before any
  gradient exists, and ``Compressor.execute`` consumes it after the
  backward pass (``overlap="post"``), or each bucket's hook starts its
  collective inside the backward pass (``overlap="fused"``,
  ``core.overlap``; segmented bucket pipelines: covap, none, fp16).
* Gradients come from ``loss.backward()``; every worker holds its own
  un-reduced gradients, and the compressor decides exactly which bytes
  cross the process group (one ``all_reduce`` per selected segment, or
  the all-gathers of each bucket's codes on the flat path of ``fp8wire``
  and ``efsignsgd``, or of its top-k values and indices under ``topk`` and
  ``dgc``, ``randomk``'s all-reduce of k values, ``oktopk``'s all-to-all
  and all-gather, or two all-reduces of each leaf's low-rank factors under
  ``powersgd``, options through ``compressor_options``).
* Loss metrics are averaged over the process group.
* ``arena=True`` runs the zero-copy arena form of the sync
  (``core.arena``); ``sync="sharded"`` reduce-scatters each selected
  bucket, clips on the all-reduced sum of the local squared norms, and
  all-gathers the updated params at the head of the next step: every
  bucket's gather starts there, and the forward pass waits for each one
  before the first layer that reads it (once more, blocking, in
  :meth:`Trainer.flush_sync` when ``run`` ends).

``TrainConfig.interval`` is an integer, as in the reference: callers
resolve ``"auto"`` first (``repro_torch.api.resolve_interval``, which
``api.fit`` and the CLI call).  :meth:`Trainer.replan` adopts another
interval between steps, carrying the EF residuals across
(``runtime.transitions``).  Hierarchical pods are not ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import torch
import torch.distributed as dist

from ..core import build_plan, get_compressor
from ..core.bucketing import BucketPlan
from ..core.comm import Compressor, world_size
from ..core.overlap import (
    EMBED_STAGE,
    bucket_first_use,
    issue_param_allgather,
    overlapped_loss_and_grads,
    sharded_param_allgather,
    supports_fused_overlap,
)
from ..core.schedule import CommSchedule, mean_bytes_per_step
from ..optim import Optimizer, apply_updates, clip_by_global_norm, global_norm


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    compressor: str = "covap"
    compressor_options: dict = dataclasses.field(default_factory=dict)
    interval: int = 4                      # COVAP I = ceil(CCR); 1 = no filter
    bucket_bytes: int = 25 * 1024 * 1024
    max_buckets: int = 128
    clip_norm: float = 0.0                 # 0 = off
    steps: int = 100
    log_every: int = 10
    # "post": sync after the backward pass; "fused": each bucket's
    # collective starts inside it (core/overlap.py)
    overlap: str = "post"
    # zero-copy gradient arena (core/arena.py): bucket payloads are static
    # slot views of flat per-phase planes, packed by one fused pass
    arena: bool = False
    # "allreduce" or "sharded": reduce-scatter the compressed slot, the
    # optimizer's meaningful updates on the local shard, and the deferred
    # param all-gather at the next step's head
    sync: str = "allreduce"

    def __post_init__(self):
        if isinstance(self.interval, str):
            raise ValueError(
                f"TrainConfig.interval is an integer; resolve {self.interval!r} "
                "first with repro_torch.api.resolve_interval (api.fit and the "
                "CLI do)"
            )
        if self.overlap not in ("post", "fused"):
            raise ValueError(
                f"overlap must be 'post' or 'fused', got {self.overlap!r}")


def make_compressor(tc: TrainConfig) -> Compressor:
    opts = dict(tc.compressor_options)
    if tc.compressor == "covap":
        opts.setdefault("interval", tc.interval)
    if tc.arena:
        opts.setdefault("use_arena", True)
    if tc.sync != "allreduce":
        opts.setdefault("sync", tc.sync)
    return get_compressor(tc.compressor, **opts)


def _pmean_metrics(metrics: dict[str, torch.Tensor], group) -> dict[str, torch.Tensor]:
    """Average scalar metrics over the group with one all-reduce."""
    if group is None:
        return metrics
    keys = sorted(metrics)
    packed = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(packed, op=dist.ReduceOp.AVG, group=group)
    return dict(zip(keys, packed.unbind(0)))


def loss_and_grads(model, params: list[torch.Tensor], batch, group=None, *,
                   before_layer=None):
    """Forward + ``backward()`` on this worker's batch; ``before_layer``
    (``None``: no callback) goes to ``model.loss_fn``.

    -> ``(grads, metrics)``: the raw (un-synced) gradients in leaf order, and
    the loss metrics averaged over the group.  The parameters' ``.grad``
    fields are cleared again before returning."""
    for p in params:
        p.grad = None
    total, metrics = model.loss_fn(batch, before_layer=before_layer)
    total.backward()
    grads = [p.grad for p in params]
    for p in params:
        p.grad = None
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["total_loss"] = total.detach()
    return grads, _pmean_metrics(metrics, group)


@torch.no_grad()
def _sharded_grad_norm(synced: list[torch.Tensor], group) -> torch.Tensor:
    """Global gradient norm under sharded sync: each worker's ``synced`` is
    zero off its owned shards, so the global square-sum is the all-reduced
    sum of the local ones (summed in another order than the allreduce
    path's norm, so the two agree to an ulp, not bitwise)."""
    sq = sum(torch.sum(torch.square(x.float())) for x in synced)
    dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=group)
    return torch.sqrt(sq)


def build_step_fn(model, optimizer: Optimizer, compressor: Compressor,
                  plan: BucketPlan, *, phase: int, group=None,
                  clip_norm: float = 0.0) -> Callable:
    """The per-phase post step: :func:`loss_and_grads`, ``compressor.execute``
    on this phase's static schedule, optional global-norm clip, optimizer
    update in place.

    Sharded sync with a group: every step begins by starting the deferred
    param all-gather of the previous step (``overlap.issue_param_allgather``,
    one asynchronous gather per bucket, in order of first use); the buckets
    the embedding reads are waited for before the forward pass, every other
    bucket in ``model.loss_fn``'s ``before_layer`` callback, before the
    first layer that reads it, or before the final norm and head.  It
    covers every bucket and rewrites values that already agree, so it runs
    from step 0.  ``step_fn.gather_events`` holds the last step's
    ``("issue", b)``, ``("settle", b)`` and ``("layer", i)`` events.

    ``step_fn(state, batch) -> (state, metrics)``; ``state`` is
    ``{"params", "opt", "comp", "step"}`` as :func:`make_train_state`
    builds it, and its ``params`` are the model's parameters.
    ``step_fn.update(state, grads) -> (state, grad_norm)`` is the part after
    the backward pass, for callers that hold gradients already."""
    return _build_phase_step(model, optimizer, compressor, plan, phase=phase,
                             group=group, clip_norm=clip_norm, fused=False)


def build_overlapped_step(model, optimizer: Optimizer, compressor: Compressor,
                          plan: BucketPlan, *, phase: int, group=None,
                          clip_norm: float = 0.0) -> Callable:
    """The fused per-phase step (``TrainConfig(overlap="fused")``): the
    contract of :func:`build_step_fn`, with each bucket's collective started
    inside the backward pass by its hook (``core.overlap``) and waited for
    after it.  The same values as the post step, given the same gradients.
    Under sharded sync the head all-gathers start before the hooks are
    installed.  ``step_fn.fired`` and ``step_fn.hook_streams`` hold the
    order the last step's hooks fired in, and the stream current at their
    install beside the CUDA stream each ran on."""
    _require_fused(compressor)
    return _build_phase_step(model, optimizer, compressor, plan, phase=phase,
                             group=group, clip_norm=clip_norm, fused=True)


def _require_fused(compressor) -> None:
    if not supports_fused_overlap(compressor):
        raise ValueError(
            f"overlap='fused' requires a segmented bucket pipeline (covap / none "
            f"/ fp16); {compressor!r} must use overlap='post'")


def _build_phase_step(model, optimizer, compressor, plan, *, phase, group,
                      clip_norm, fused) -> Callable:
    """The skeleton both steps share; only the gradient and sync block
    differs."""
    comm_schedule = compressor.plan_phase(plan, phase, world=world_size(group))
    sharded = (getattr(compressor, "sync_mode", "allreduce") == "sharded"
               and group is not None)
    first_use = (bucket_first_use(plan, model.cfg.num_layers) if sharded
                 else None)

    def apply(state, synced, comp_state):
        params = state["params"]
        if sharded:
            gnorm = _sharded_grad_norm(synced, group)
            if clip_norm > 0:
                scale = torch.clamp(clip_norm / (gnorm + 1e-12), max=1.0)
                synced = [(x.float() * scale).to(x.dtype) for x in synced]
        elif clip_norm > 0:
            synced, gnorm = clip_by_global_norm(synced, clip_norm)
        else:
            gnorm = global_norm(synced)
        updates, opt_state = optimizer.update(synced, state["opt"], params)
        apply_updates(params, updates)
        new_state = {"params": params, "opt": opt_state, "comp": comp_state,
                     "step": state["step"] + 1}
        return new_state, gnorm

    def update(state, grads):
        synced, comp_state, _ = compressor.execute(
            comm_schedule, grads, state["comp"], step=state["step"], group=group,
        )
        return apply(state, synced, comp_state)

    def step_fn(state, batch):
        before_layer = None
        if sharded:
            gather = issue_param_allgather(compressor, comm_schedule,
                                           state["params"], group=group,
                                           first_use=first_use)
            gather.settle_through(EMBED_STAGE)
            before_layer = gather.before_layer
            step_fn.gather_events = gather.events
        if fused:
            loss, metrics, synced, comp_state, _, hooks = overlapped_loss_and_grads(
                model, compressor, comm_schedule, state["params"], state["comp"],
                batch, state["step"], group=group, before_layer=before_layer)
            metrics["total_loss"] = loss
            metrics = _pmean_metrics(metrics, group)
            step_fn.fired = hooks.fired
            step_fn.hook_streams = (hooks.forward_stream, hooks.streams)
        else:
            grads, metrics = loss_and_grads(model, state["params"], batch, group,
                                            before_layer=before_layer)
        if sharded and gather.pending:
            raise RuntimeError(
                f"sharded sync: buckets {sorted(gather.pending)} were never "
                "waited for: the model did not call before_layer for every "
                "stage")
        new_state, metrics["grad_norm"] = (apply(state, synced, comp_state) if fused
                                           else update(state, grads))
        return new_state, metrics

    step_fn.comm_schedule = comm_schedule
    step_fn.gather_events = []
    step_fn.fired = []
    step_fn.hook_streams = (None, [])
    step_fn.update = update
    return step_fn


def make_train_state(model, optimizer, compressor, plan) -> dict:
    params = [p for _, p in model.named_leaves()]
    return {
        "params": params,
        "opt": optimizer.init(params),
        "comp": compressor.init_state(params, plan),
        "step": 0,
    }


class Trainer:
    """Host loop: one step function per COVAP phase, built lazily; logs
    metrics; exposes the static per-phase ``CommSchedule``s.

    ``group`` is the data-parallel process group (``None``: one worker, no
    collectives).  Each worker feeds its own batches to :meth:`run`."""

    def __init__(self, model, optimizer: Optimizer, tc: TrainConfig, *,
                 group=None):
        self.model = model
        self.optimizer = optimizer
        self.tc = tc
        self.group = group
        self.compressor = make_compressor(tc)
        self.plan = build_plan(
            model.named_leaves(),
            bucket_bytes=tc.bucket_bytes,
            max_buckets=tc.max_buckets,
            interval=tc.interval,
        )
        self._steps: dict[int, Callable] = {}
        self.history: list[dict] = []
        self.transitions: list = []
        self._pending_sync = False
        self.gather_events: list[tuple[str, int]] = []
        self.last_step_fn: Callable | None = None
        if tc.overlap == "fused":
            _require_fused(self.compressor)

    @property
    def num_phases(self) -> int:
        return self.compressor.num_phases()

    @property
    def leaf_names(self) -> list[str]:
        """The model's leaf paths in leaf order, the keys of a checkpoint
        (``checkpoint.save_train_state(..., names=)``)."""
        return [path for path, _ in self.model.named_leaves()]

    @property
    def dp_world(self) -> int:
        return world_size(self.group)

    def schedules(self) -> list[CommSchedule]:
        """Static comm plan of every phase."""
        return [
            self.compressor.plan_phase(self.plan, p, world=self.dp_world)
            for p in range(self.num_phases)
        ]

    def schedule_report(self) -> dict:
        scheds = self.schedules()
        mean = mean_bytes_per_step(scheds)
        out = {
            "compressor": self.tc.compressor,
            "num_phases": len(scheds),
            "bytes_per_worker_per_phase": [s.bytes_per_worker for s in scheds],
            "mean_bytes_per_step": mean,
            "dense_bytes": scheds[0].dense_bytes if scheds else 0,
            "volume_ratio": scheds[0].dense_bytes / max(mean, 1) if scheds else 1.0,
        }
        if self.sharded:
            n = max(len(scheds), 1)
            out["sync"] = self.tc.sync
            out["mean_exposed_wire_bytes_per_step"] = (
                sum(s.exposed_wire_bytes(self.dp_world) for s in scheds) / n
            )
            out["mean_deferred_bytes_per_step"] = (
                sum(s.deferred_bytes_per_worker for s in scheds) / n
            )
        return out

    def _phase_fn(self, phase: int) -> Callable:
        if phase not in self._steps:
            build = (build_overlapped_step if self.tc.overlap == "fused"
                     else build_step_fn)
            self._steps[phase] = build(
                self.model, self.optimizer, self.compressor, self.plan,
                phase=phase, group=self.group, clip_norm=self.tc.clip_norm,
            )
        return self._steps[phase]

    @property
    def sharded(self) -> bool:
        return self.tc.sync == "sharded"

    def flush_sync(self, state: dict) -> dict:
        """Settle the last step's pending deferred gather (sharded sync):
        all-gather the params and every params-shaped part of the optimizer
        state (Adam's m and v, SGD's mu) from their shard owners, in place,
        so every worker holds the values the allreduce path would.  A no-op
        for allreduce runs, single-worker runs and when nothing is
        pending."""
        if not self.sharded or not self._pending_sync:
            return state
        self._pending_sync = False
        if self.group is None:
            return state
        schedule = self.compressor.plan_phase(self.plan, 0, world=self.dp_world)
        shapes = [tuple(p.shape) for p in state["params"]]

        def gather(tree):
            if (isinstance(tree, (list, tuple)) and len(tree) == len(shapes)
                    and all(isinstance(x, torch.Tensor) and tuple(x.shape) == s
                            for x, s in zip(tree, shapes))):
                sharded_param_allgather(self.compressor, schedule, tree,
                                        group=self.group)
            elif isinstance(tree, dict):
                for v in tree.values():
                    gather(v)

        gather(state["params"])
        gather(state["opt"])
        return state

    def init_state(self, seed: int | None = None) -> dict:
        """Fresh optimizer and EF state over the model's parameters; with a
        ``seed`` the parameters are re-initialised from it first."""
        if seed is not None:
            self.model.init_params(seed)
        return make_train_state(self.model, self.optimizer, self.compressor, self.plan)

    def replan(self, interval: int, state: dict | None = None, *,
               policy: str = "carry", step: int = 0,
               old_interval: int | None = None):
        """Adopt a new COVAP interval at a safe boundary (between steps): a
        new compressor, a new bucket plan and (built lazily) new phase step
        functions, with the EF residual carried across the switch by
        ``runtime.transitions`` so that its norm survives.  Under the fused
        overlap the next step's hooks are built against the new plan (each
        step creates its hooks from its schedule).

        ``old_interval`` is the cadence the residual in ``state`` was
        accumulated under; it defaults to this trainer's interval and must
        be given when the state came from elsewhere (a checkpoint saved
        under another config).  Returns ``(state, TransitionReport)``, or
        ``(None, None)`` without a state."""
        from ..runtime.transitions import carry_comp_state

        if old_interval is None:
            old_interval = self.tc.interval
        if state is not None:
            # sharded sync: the pending deferred gather belongs to the old
            # plan's schedules, so it settles before the plan is replaced
            state = self.flush_sync(state)
        self.tc = dataclasses.replace(self.tc, interval=int(interval))
        self.compressor = make_compressor(self.tc)
        if self.tc.overlap == "fused":
            _require_fused(self.compressor)
        self.plan = build_plan(
            self.model.named_leaves(),
            bucket_bytes=self.tc.bucket_bytes,
            max_buckets=self.tc.max_buckets,
            interval=self.tc.interval,
        )
        self._steps = {}         # the old plan's step functions
        report = None
        if state is not None:
            comp, report = carry_comp_state(
                state["comp"],
                new_compressor=self.compressor,
                new_plan=self.plan,
                params_like=state["params"],
                step=step,
                old_interval=old_interval,
                new_interval=self.tc.interval,
                policy=policy,
            )
            state = {**state, "comp": comp}
            self.transitions.append(report)
        return state, report

    def step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """One training step of the phase ``state["step"] % num_phases``;
        ``gather_events`` then holds its head all-gather's events (sharded
        sync with a group; empty otherwise), and ``last_step_fn`` the step
        function that ran (with the fused overlap's records of the step)."""
        fn = self._phase_fn(state["step"] % self.num_phases)
        out = fn(state, batch)
        self.gather_events = fn.gather_events
        self.last_step_fn = fn
        return out

    def run(self, state: dict, batches: Iterable[dict], steps: int | None = None,
            log=print) -> dict:
        steps = steps if steps is not None else self.tc.steps
        it = iter(batches)
        t0 = time.perf_counter()
        for i in range(steps):
            state, metrics = self.step(state, next(it))
            self._pending_sync = self.sharded
            if (i + 1) % self.tc.log_every == 0 or i == 0:
                m = {k: float(v) for k, v in metrics.items()}   # syncs the device
                m["step"] = state["step"]
                m["wall_s"] = time.perf_counter() - t0
                self.history.append(m)
                if log:
                    log(
                        f"step {state['step']:>5d}  loss {m['loss']:.4f}  "
                        f"gnorm {m['grad_norm']:.3f}  t {m['wall_s']:.1f}s"
                    )
        # sharded sync: the last step's deferred gather has no next step
        return self.flush_sync(state)
