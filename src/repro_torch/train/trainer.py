"""Data-parallel trainer: COVAP wired into the gradient synchronisation of a
``torch.distributed`` data-parallel step (the counterpart of
``repro.train.trainer``).

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
(``runtime.transitions``); ``Trainer.run(autotune=...)`` re-plans online
from the measured CCR (``runtime.controller``), ``telemetry=`` records
the run (``obs``), and ``guards=`` / ``faults=`` arm the resilience
runtime (``resilience``).

Hierarchical pods (``TrainConfig.pod_interval > 1`` with a ``pod_group``):
the compressor's collectives run over the intra-pod ``group`` only, and
after the optimizer update :func:`pod_reconcile` averages the parameters
of the buckets that the coarse filter selects at the pod level (``(b +
step) % pod_interval == 0``) across the pods, each worker exchanging only
the ``1/W`` shard of the bucket it owns.  Pods drift between
reconciliations, at most ``pod_interval`` steps a bucket.  Each rank holds
its own state; ``launch.mesh.build_groups`` builds the two groups.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Iterable

import torch
import torch.distributed as dist

from ..core import arena as ar
from ..core import bucketing as bk
from ..core import build_plan, get_compressor
from ..core.bucketing import EMBED_STAGE, BucketPlan, bucket_first_use
from ..core.comm import (
    Compressor,
    all_gather_tiled,
    flat_axis_index,
    pod_shard_exchange,
    world_size,
)
from ..core.filter import selected_buckets
from ..core.overlap import (
    issue_param_allgather,
    overlapped_loss_and_grads,
    sharded_param_allgather,
    supports_fused_overlap,
)
from ..core.schedule import CollectiveCall, CommSchedule, mean_bytes_per_step
from ..obs import NULL_TELEMETRY, as_telemetry, plan_digest, span
from ..optim import Optimizer, clip_by_global_norm
from ..runtime.monitor import synchronize


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    compressor: str = "covap"
    compressor_options: dict = dataclasses.field(default_factory=dict)
    interval: int = 4                      # COVAP I = ceil(CCR); 1 = no filter
    pod_interval: int = 1                  # hierarchical COVAP across pods
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
    with span("train/metrics"):
        keys = sorted(metrics)
        packed = torch.stack([metrics[k].detach().float() for k in keys])
        dist.all_reduce(packed, op=dist.ReduceOp.AVG, group=group)
        return dict(zip(keys, packed.unbind(0)))


def loss_and_grads(model, params: list[torch.Tensor], batch, group=None, *,
                   before_layer=None):
    """Forward + ``backward()`` on this worker's batch; ``before_layer``
    (``None``: no callback) goes to ``model.loss_fn``.

    -> ``(grads, metrics)``: the raw (un-synced) gradients in leaf order, and
    the loss metrics averaged over the group.  A leaf the loss does not
    reach gets a zero gradient, as ``jax.grad`` gives it.  The parameters'
    ``.grad`` fields are cleared again before returning."""
    for p in params:
        p.grad = None
    with span("train/forward"):
        total, metrics = model.loss_fn(batch, before_layer=before_layer)
    with span("train/backward"):
        total.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
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


def plan_pod_schedule(plan: BucketPlan, *, pod_phase: int, pod_interval: int,
                      sync: str = "allreduce", intra_world: int = 1,
                      n_pods: int = 1) -> CommSchedule:
    """The static cross-pod reconciliation plan: the coarse filter's rule
    applied at the pod level.

    With ``intra_world <= 1`` each selected bucket is one f32 all-reduce of
    its full extent over the pod group.  With ``intra_world = W > 1`` it is
    the two-level decomposition :func:`pod_reconcile` runs: per selected
    bucket a cross-pod (``"dcn"``) all-reduce of only the owned ``1/W``
    shard of its W-aligned slot, at the bucket's dtype, plus, under
    ``sync="allreduce"`` only, the intra-pod (``"ici"``) all-gather that
    rebuilds the full slot.  Under ``sync="sharded"`` the next step's head
    all-gather rebuilds it, so no intra-pod call is planned here."""
    interval = max(int(pod_interval), 1)
    sel = selected_buckets(plan.num_buckets, pod_phase % interval, interval)
    W = max(int(intra_world), 1)
    pod_world = int(n_pods) if int(n_pods) > 1 else 0
    calls: list[CollectiveCall] = []
    for b in sel:
        bucket = plan.buckets[b]
        if W <= 1:
            calls.append(CollectiveCall(f"pod-bucket:{b}", "all_reduce", "float32",
                                        bucket.numel * 4, link="dcn", world=pod_world))
            continue
        dt = ar.bucket_dtype(plan, bucket)
        name = ar._dtype_name(dt)
        shard_bytes = ar.aligned_numel(bucket.numel, W) // W * dt.itemsize
        calls.append(CollectiveCall(f"pod-bucket:{b}", "all_reduce", name, shard_bytes,
                                    link="dcn", world=pod_world))
        if sync == "allreduce":
            calls.append(CollectiveCall(f"pod-ag:{b}", "all_gather", name, shard_bytes,
                                        link="ici", world=W))
    return CommSchedule(
        compressor="pod_reconcile", phase=pod_phase % interval, num_phases=interval,
        granularity="bucket", selected=sel, calls=tuple(calls),
        dense_bytes=sum(b.numel for b in plan.buckets) * 4, plan=plan,
    )


def hierarchical_schedules(compressor, plan: BucketPlan, *, pod_interval: int,
                           sync: str = "allreduce", intra_world: int = 1,
                           n_pods: int = 1) -> list[CommSchedule]:
    """One merged schedule per phase of the full ``lcm(phases, pod_interval)``
    cycle: the intra-pod gradient calls (``link="ici"``) followed by that
    step's cross-pod reconciliation calls (``link="dcn"``, and the intra-pod
    rebuild under allreduce sync).  Static: no group is needed to plan."""
    n = max(compressor.num_phases(), 1)
    total = math.lcm(n, max(int(pod_interval), 1))
    base = [compressor.plan_phase(plan, p, world=intra_world) for p in range(n)]
    out = []
    for p in range(total):
        g = base[p % n]
        pod = plan_pod_schedule(plan, pod_phase=p % pod_interval,
                                pod_interval=pod_interval, sync=sync,
                                intra_world=intra_world, n_pods=n_pods)
        ranks = g.ready_ranks
        if ranks:
            # pod calls issue after every gradient collective
            ranks = ranks + tuple(range(len(ranks), len(ranks) + len(pod.calls)))
        out.append(dataclasses.replace(g, phase=p, num_phases=total,
                                       calls=g.calls + pod.calls, ready_ranks=ranks))
    return out


@torch.no_grad()
def pod_reconcile(params: list[torch.Tensor], schedule: CommSchedule, *, group,
                  pod_group, owned_only: bool = False,
                  layout: ar.ArenaLayout | None = None) -> int:
    """Hierarchical COVAP's cross-pod level, in place on ``params``: the
    parameters of the buckets the pod schedule selects are averaged across
    the pods.

    Each selected bucket is packed into its W-aligned arena slot (W the
    intra-pod world); worker ``w`` slices the shard ``[w*S, (w+1)*S)`` it
    owns (under allreduce sync the params agree inside the pod, so the
    slice is exact; under sharded sync it is the shard the optimizer just
    updated), and :func:`~repro_torch.core.comm.pod_shard_exchange`
    averages it over the pod group.  Then:

    * ``owned_only=False`` (allreduce sync): an intra-pod all-gather
      rebuilds the full slot on every worker;
    * ``owned_only=True`` (sharded sync): only the owned shard changes; the
      other positions stay stale, and the next step's head all-gather,
      which always gathers from the shard owners, freshens them.

    ``layout`` is the schedule's W-aligned layout (``arena.build_layout(
    plan, schedule.selected, align=W)``), built here when not given.
    Returns ``schedule.bytes_per_worker``."""
    if not schedule.selected:
        return schedule.bytes_per_worker
    plan = schedule.plan
    W = world_size(group)
    if layout is None:
        layout = ar.build_layout(plan, schedule.selected, align=W)
    planes = ar.pack_leaves(layout, params)
    w = flat_axis_index(group)
    for b in schedule.selected:
        view = layout.bucket_view(planes, b)
        S = view.numel() // W
        shard = pod_shard_exchange(view[w * S:(w + 1) * S], pod_group)
        # one worker a pod owns the whole slot: nothing to gather (and the
        # plan has no intra-pod call for it)
        full = view if owned_only or W == 1 else all_gather_tiled(shard, group)
        for seg, piece in zip(plan.buckets[b].segments, layout.unpack_bucket(b, full)):
            bk._update_segment(params[seg.leaf_idx], seg, piece)
    return schedule.bytes_per_worker


def build_step_fn(model, optimizer: Optimizer, compressor: Compressor,
                  plan: BucketPlan, *, phase: int, group=None,
                  clip_norm: float = 0.0, pod_group=None,
                  pod_interval: int = 1) -> Callable:
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
    the backward pass, for callers that hold gradients already.

    With a ``pod_group`` and ``pod_interval > 1`` (hierarchical pods) the
    step ends in :func:`pod_reconcile` on ``step_fn.pod_schedule``, and the
    metrics (``grad_norm`` too) are averaged over the pod group as well, so
    that every rank reads the same values."""
    return _build_phase_step(model, optimizer, compressor, plan, phase=phase,
                             group=group, clip_norm=clip_norm, fused=False,
                             pod_group=pod_group, pod_interval=pod_interval)


def build_overlapped_step(model, optimizer: Optimizer, compressor: Compressor,
                          plan: BucketPlan, *, phase: int, group=None,
                          clip_norm: float = 0.0, pod_group=None,
                          pod_interval: int = 1) -> Callable:
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
                             group=group, clip_norm=clip_norm, fused=True,
                             pod_group=pod_group, pod_interval=pod_interval)


def _require_fused(compressor) -> None:
    if not supports_fused_overlap(compressor):
        raise ValueError(
            f"overlap='fused' requires a segmented bucket pipeline (covap / none "
            f"/ fp16); {compressor!r} must use overlap='post'")


def _build_phase_step(model, optimizer, compressor, plan, *, phase, group,
                      clip_norm, fused, pod_group=None, pod_interval=1) -> Callable:
    """The skeleton both steps share; only the gradient and sync block
    differs."""
    comm_schedule = compressor.plan_phase(plan, phase, world=world_size(group))
    sync_mode = getattr(compressor, "sync_mode", "allreduce")
    sharded = sync_mode == "sharded" and group is not None
    pod_schedule = pod_layout = None
    if pod_group is not None and pod_interval > 1:
        pod_schedule = plan_pod_schedule(
            plan, pod_phase=phase % pod_interval, pod_interval=pod_interval,
            sync=sync_mode, intra_world=world_size(group),
            n_pods=world_size(pod_group))
        pod_layout = ar.build_layout(plan, pod_schedule.selected,
                                     align=world_size(group))
    first_use = bucket_first_use(plan) if sharded else None

    def apply(state, synced, comp_state):
        params = state["params"]
        with span("train/optimizer"):
            if sharded:
                gnorm = _sharded_grad_norm(synced, group)
                if clip_norm > 0:
                    scale = torch.clamp(clip_norm / (gnorm + 1e-12), max=1.0)
                    synced = [(x.float() * scale).to(x.dtype) for x in synced]
            elif clip_norm > 0:
                synced, gnorm = clip_by_global_norm(synced, clip_norm)
            if sharded or clip_norm > 0:
                opt_state = optimizer.apply(synced, state["opt"], params)
            else:
                # the norm is only reported: the step takes it from its own
                # read of the gradients
                opt_state, gnorm = optimizer.apply(synced, state["opt"], params,
                                                   with_norm=True)
        if pod_schedule is not None:
            pod_reconcile(params, pod_schedule, group=group, pod_group=pod_group,
                          owned_only=sharded, layout=pod_layout)
        new_state = {"params": params, "opt": opt_state, "comp": comp_state,
                     "step": state["step"] + 1}
        return new_state, gnorm

    def sync(state, grads):
        with span("train/sync"):
            synced, comp_state, _ = compressor.execute(
                comm_schedule, grads, state["comp"], step=state["step"], group=group,
            )
        return synced, comp_state

    def update(state, grads):
        return apply(state, *sync(state, grads))

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
        if not fused:
            synced, comp_state = sync(state, grads)
            # the raw gradients are dead once synced: free them before the
            # optimizer's step
            del grads
        new_state, metrics["grad_norm"] = apply(state, synced, comp_state)
        if pod_schedule is not None:
            metrics = _pmean_metrics(metrics, pod_group)
        return new_state, metrics

    step_fn.comm_schedule = comm_schedule
    step_fn.pod_schedule = pod_schedule
    step_fn.pod_layout = pod_layout
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
    collectives).  Each worker feeds its own batches to :meth:`run`.  With
    ``TrainConfig.pod_interval > 1`` and a ``pod_group`` the trainer is
    hierarchical: ``group`` is this rank's intra-pod group, ``pod_group``
    its cross-pod group (``launch.mesh.build_groups``), and together they
    must cover the default ``torch.distributed`` world."""

    def __init__(self, model, optimizer: Optimizer, tc: TrainConfig, *,
                 group=None, pod_group=None):
        self.model = model
        self.optimizer = optimizer
        self.tc = tc
        self.group = group
        self.pod_group = pod_group
        if pod_group is not None and tc.pod_interval <= 1:
            raise ValueError(
                f"a pod_group needs TrainConfig.pod_interval > 1 (got "
                f"{tc.pod_interval}): without a pod level the gradients sync "
                "over `group` alone and the pods would never meet; pass the "
                "whole world as `group` instead")
        if self.hierarchical and (world_size(group) * world_size(pod_group)
                                  != dist.get_world_size()):
            raise ValueError(
                f"hierarchical pods: {world_size(group)} workers a pod x "
                f"{world_size(pod_group)} pods do not cover the world of "
                f"{dist.get_world_size()}")
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
        self.runtime = None                 # the AdaptiveRuntime of run(autotune=)
        self.resilience = None              # the ResilienceRuntime of run(guards=, faults=)
        self.telemetry = NULL_TELEMETRY     # the bundle of run(telemetry=)
        if tc.overlap == "fused":
            _require_fused(self.compressor)

    @property
    def hierarchical(self) -> bool:
        return self.tc.pod_interval > 1 and self.pod_group is not None

    @property
    def n_pods(self) -> int:
        return world_size(self.pod_group) if self.hierarchical else 1

    @property
    def world_group(self):
        """The group over which every rank must agree (guards' verdicts,
        adaptive samples, checkpoints): the default world of a hierarchical
        trainer, ``group`` otherwise."""
        return dist.group.WORLD if self.hierarchical else self.group

    @property
    def num_phases(self) -> int:
        base = self.compressor.num_phases()
        if self.hierarchical:
            return math.lcm(base, self.tc.pod_interval)
        return base

    @property
    def leaf_names(self) -> list[str]:
        """The model's leaf paths in leaf order, the keys of a checkpoint
        (``checkpoint.save_train_state(..., names=)``)."""
        return [path for path, _ in self.model.named_leaves()]

    @property
    def dp_world(self) -> int:
        """World size of the compressor's collectives (the intra-pod world
        of a hierarchical trainer)."""
        return world_size(self.group)

    def schedules(self) -> list[CommSchedule]:
        """Static comm plan of every phase (hierarchical: of the full lcm
        cycle, merged with the pod calls, :func:`hierarchical_schedules`)."""
        if self.hierarchical:
            return hierarchical_schedules(
                self.compressor, self.plan, pod_interval=self.tc.pod_interval,
                sync=self.tc.sync, intra_world=self.dp_world, n_pods=self.n_pods)
        return [self.compressor.plan_phase(self.plan, p, world=self.dp_world)
                for p in range(self.num_phases)]

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
                pod_group=self.pod_group if self.hierarchical else None,
                pod_interval=self.tc.pod_interval,
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
        pending.  Hierarchical: the gather runs inside each pod, so that
        the pods keep their drift."""
        if not self.sharded or not self._pending_sync:
            return state
        self._pending_sync = False
        if self.telemetry.enabled:
            self.telemetry.events.emit("flush", step=int(state["step"]),
                                       reason="deferred-allgather")
        self.settle_gather(state, self.compressor, self.plan)
        return state

    def settle_gather(self, state: dict, compressor, plan) -> None:
        """The gather of :meth:`flush_sync` under ``compressor`` and ``plan``
        (the recovery runtime settles a rollback copy taken under an earlier
        plan with it).  A no-op without a group."""
        if self.group is None:
            return
        schedule = compressor.plan_phase(plan, 0, world=self.dp_world)
        shapes = [tuple(p.shape) for p in state["params"]]

        def gather(tree):
            if (isinstance(tree, (list, tuple)) and len(tree) == len(shapes)
                    and all(isinstance(x, torch.Tensor) and tuple(x.shape) == s
                            for x, s in zip(tree, shapes))):
                sharded_param_allgather(compressor, schedule, tree, group=self.group)
            elif isinstance(tree, dict):
                for v in tree.values():
                    gather(v)

        gather(state["params"])
        gather(state["opt"])

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
            log=print, autotune=None, telemetry=None, guards=None,
            faults=None) -> dict:
        """Host loop.  ``autotune`` (None | True | ``AutotuneConfig`` | a live
        ``AdaptiveRuntime``) arms the adaptive runtime: measured-CCR
        probes, hysteresis re-planning and timeline tracing.  A live
        ``AdaptiveRuntime`` keeps its monitor and controller across chunked
        ``run`` calls (checkpoint-every loops).  A step is timed only when
        the runtime will probe after it (``due_next``), and that step alone
        ends in a device synchronisation.

        ``telemetry`` (None | directory path | ``repro_torch.obs.Telemetry``)
        records a run manifest and step records into the event log, the
        step counter, loss and gradient norm into the registry, and the
        adaptive runtime's spans and decisions into the bundle, all at the
        log cadence, where the metrics are read anyway.

        ``guards`` (None | True | ``GuardConfig`` | dict of overrides | a live
        ``ResilienceRuntime``) arms the resilience runtime: numeric guards on
        each step's metrics and the skip-step -> EF-flush -> checkpoint-rewind
        ladder; ``faults`` (None | spec string | ``FaultPlan`` |
        ``FaultInjector``) arms seeded fault injection.  A live runtime keeps
        its ladder and fault budgets across chunked ``run`` calls.  Its
        checks run before the adaptive runtime sees the state, so that a
        poisoned step feeds no probe; with faults and an armed adaptive
        runtime, ``ccr_skew`` rides the runtime's probe.

        With ``autotune``, ``telemetry``, ``guards`` and ``faults`` all None
        the loop is the static one."""
        steps = steps if steps is not None else self.tc.steps
        tel = as_telemetry(telemetry)
        if tel.enabled:
            self.telemetry = tel
            tel.manifest_once(
                role="train",
                config=dataclasses.asdict(self.tc),
                plan={
                    "digest": plan_digest(self.plan),
                    "num_buckets": self.plan.num_buckets,
                    "num_phases": self.num_phases,
                    "bucket_bytes_target": self.plan.bucket_bytes_target,
                },
                world=self.dp_world,
                mesh=({"pod": self.n_pods, "data": self.dp_world}
                      if self.hierarchical else None),
            )
        rt = None
        if autotune is not None and autotune is not False:
            from ..runtime import AdaptiveRuntime, as_autotune_config

            if isinstance(autotune, AdaptiveRuntime):
                rt = self.runtime = autotune
            else:
                rt = self.runtime = AdaptiveRuntime(self, as_autotune_config(autotune))
            if tel.enabled:
                rt.attach_telemetry(tel)
        res = None
        if guards is not None or faults is not None:
            from ..resilience import ResilienceRuntime

            if isinstance(guards, ResilienceRuntime):
                res = self.resilience = guards
            else:
                res = self.resilience = ResilienceRuntime(self, guards=guards,
                                                          faults=faults)
            if tel.enabled:
                res.attach_telemetry(tel)
            if (res.injector is not None and rt is not None
                    and getattr(rt._probe, "skewed_by", None) is not res.injector):
                # ccr_skew rides the probe: the wrapper shadows the method,
                # once per runtime (a chunked loop passes the same runtimes)
                rt._probe = res.injector.wrap_probe(rt._probe)
        steps_c = tel.registry.counter("train_steps_total", "optimizer steps completed")
        loss_g = tel.registry.gauge("train_loss", "last logged total loss")
        gnorm_g = tel.registry.gauge("train_grad_norm",
                                     "last logged global gradient norm")
        it = iter(batches)
        t0 = time.perf_counter()
        for i in range(steps):
            batch = next(it)
            if res is not None:
                # guard-owned checkpoint -> rollback copy -> fault injection
                state, batch = res.pre_step(state, batch)
            phase = state["step"] % self.num_phases
            timed = rt is not None and rt.due_next()
            t_step = time.perf_counter() if timed else 0.0
            state, metrics = self.step(state, batch)
            steps_c.inc()
            self._pending_sync = self.sharded
            if res is not None:
                # before the adaptive runtime: a poisoned step must not feed
                # the probe or cross a re-plan boundary
                state = res.post_step(state, metrics)
            if rt is not None:
                wall = None
                if timed:
                    synchronize(state["params"][0].device)
                    wall = time.perf_counter() - t_step
                state = rt.after_step(state, batch, wall_s=wall, log=log)
            if (i + 1) % self.tc.log_every == 0 or i == 0:
                m = {k: float(v) for k, v in metrics.items()}   # syncs the device
                m["step"] = state["step"]
                m["wall_s"] = time.perf_counter() - t0
                self.history.append(m)
                if tel.enabled:
                    loss_g.set(m["total_loss"])
                    gnorm_g.set(m["grad_norm"])
                    tel.events.emit(
                        "step", step=int(state["step"]), loss=m["total_loss"],
                        grad_norm=m["grad_norm"], wall_s=m["wall_s"],
                        phase=int(phase),
                        metrics={k: v for k, v in m.items()
                                 if k not in ("step", "wall_s")},
                    )
                if log:
                    # only total_loss and grad_norm are certain to be there
                    shown = m.get("loss", m["total_loss"])
                    log(
                        f"step {state['step']:>5d}  loss {shown:.4f}  "
                        f"gnorm {m['grad_norm']:.3f}  t {m['wall_s']:.1f}s"
                    )
        if res is not None:
            # drain the deferred checks (may recover: the state can then sit
            # behind the loop's nominal target)
            state = res.finalize(state)
        if rt is not None:
            rt.finish()
        # sharded sync: the last step's deferred gather has no next step
        return self.flush_sync(state)
