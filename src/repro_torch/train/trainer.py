"""Data-parallel trainer: COVAP wired into the gradient synchronisation of a
``torch.distributed`` data-parallel step (the post path of
``repro.train.trainer``).

* One step function per ``phase = step % I``: each phase's
  ``CommSchedule`` is planned when the step function is built, before any
  gradient exists, and ``Compressor.execute`` consumes it after the
  backward pass (``overlap="post"``).
* Gradients come from ``loss.backward()``; every worker holds its own
  un-reduced gradients, and the compressor decides exactly which bytes
  cross the process group (one ``all_reduce`` per selected segment).
* Loss metrics are averaged over the process group.

Not ported yet (they raise): ``overlap="fused"``, ``arena=True``,
``sync="sharded"``, hierarchical pods, ``interval="auto"``.
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
    overlap: str = "post"                  # only "post" is ported
    arena: bool = False                    # only False is ported
    sync: str = "allreduce"                # only "allreduce" is ported

    def __post_init__(self):
        if self.interval == "auto":
            raise NotImplementedError(
                "interval='auto' needs the analytic CCR, which is not ported; "
                "pass an integer interval"
            )
        if self.overlap != "post":
            raise NotImplementedError(
                f"overlap={self.overlap!r} is not ported; only 'post' is"
            )
        if self.arena:
            raise NotImplementedError("arena=True is not ported")
        if self.sync != "allreduce":
            raise NotImplementedError(
                f"sync={self.sync!r} is not ported; only 'allreduce' is"
            )


def make_compressor(tc: TrainConfig) -> Compressor:
    opts = dict(tc.compressor_options)
    if tc.compressor == "covap":
        opts.setdefault("interval", tc.interval)
    return get_compressor(tc.compressor, **opts)


def _pmean_metrics(metrics: dict[str, torch.Tensor], group) -> dict[str, torch.Tensor]:
    """Average scalar metrics over the group with one all-reduce."""
    if group is None:
        return metrics
    keys = sorted(metrics)
    packed = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(packed, op=dist.ReduceOp.AVG, group=group)
    return dict(zip(keys, packed.unbind(0)))


def loss_and_grads(model, params: list[torch.Tensor], batch, group=None):
    """Forward + ``backward()`` on this worker's batch.

    -> ``(grads, metrics)``: the raw (un-synced) gradients in leaf order, and
    the loss metrics averaged over the group.  The parameters' ``.grad``
    fields are cleared again before returning."""
    for p in params:
        p.grad = None
    total, metrics = model.loss_fn(batch)
    total.backward()
    grads = [p.grad for p in params]
    for p in params:
        p.grad = None
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["total_loss"] = total.detach()
    return grads, _pmean_metrics(metrics, group)


def build_step_fn(model, optimizer: Optimizer, compressor: Compressor,
                  plan: BucketPlan, *, phase: int, group=None,
                  clip_norm: float = 0.0) -> Callable:
    """The per-phase step: :func:`loss_and_grads`, ``compressor.execute`` on
    this phase's static schedule, optional global-norm clip, optimizer update
    in place.

    ``step_fn(state, batch) -> (state, metrics)``; ``state`` is
    ``{"params", "opt", "comp", "step"}`` as :func:`make_train_state`
    builds it, and its ``params`` are the model's parameters.
    ``step_fn.update(state, grads) -> (state, grad_norm)`` is the part after
    the backward pass, for callers that hold gradients already."""
    comm_schedule = compressor.plan_phase(plan, phase, world=world_size(group))

    def update(state, grads):
        params = state["params"]
        synced, comp_state, _ = compressor.execute(
            comm_schedule, grads, state["comp"], step=state["step"], group=group,
        )
        if clip_norm > 0:
            synced, gnorm = clip_by_global_norm(synced, clip_norm)
        else:
            gnorm = global_norm(synced)
        updates, opt_state = optimizer.update(synced, state["opt"], params)
        apply_updates(params, updates)
        new_state = {"params": params, "opt": opt_state, "comp": comp_state,
                     "step": state["step"] + 1}
        return new_state, gnorm

    def step_fn(state, batch):
        grads, metrics = loss_and_grads(model, state["params"], batch, group)
        new_state, metrics["grad_norm"] = update(state, grads)
        return new_state, metrics

    step_fn.comm_schedule = comm_schedule
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

    @property
    def num_phases(self) -> int:
        return self.compressor.num_phases()

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
        return {
            "compressor": self.tc.compressor,
            "num_phases": len(scheds),
            "bytes_per_worker_per_phase": [s.bytes_per_worker for s in scheds],
            "mean_bytes_per_step": mean,
            "dense_bytes": scheds[0].dense_bytes if scheds else 0,
            "volume_ratio": scheds[0].dense_bytes / max(mean, 1) if scheds else 1.0,
        }

    def _phase_fn(self, phase: int) -> Callable:
        if phase not in self._steps:
            self._steps[phase] = build_step_fn(
                self.model, self.optimizer, self.compressor, self.plan,
                phase=phase, group=self.group, clip_norm=self.tc.clip_norm,
            )
        return self._steps[phase]

    def init_state(self, seed: int | None = None) -> dict:
        """Fresh optimizer and EF state over the model's parameters; with a
        ``seed`` the parameters are re-initialised from it first."""
        if seed is not None:
            self.model.init_params(seed)
        return make_train_state(self.model, self.optimizer, self.compressor, self.plan)

    def step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """One training step of the phase ``state["step"] % num_phases``."""
        return self._phase_fn(state["step"] % self.num_phases)(state, batch)

    def run(self, state: dict, batches: Iterable[dict], steps: int | None = None,
            log=print) -> dict:
        steps = steps if steps is not None else self.tc.steps
        it = iter(batches)
        t0 = time.perf_counter()
        for i in range(steps):
            state, metrics = self.step(state, next(it))
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
        return state
