"""Compressor interface, registry and collectives, built on the
plan/execute split (the counterpart of ``repro.core.comm``)::

    schedule = comp.plan_phase(plan, phase, world=W)   # static
    synced, new_state, stats = comp.execute(schedule, grads, state,
                                            step=step, group=group)

``group`` is the ``torch.distributed`` process group of the data-parallel
workers.  With ``group=None`` the compressor runs in single-worker mode and
every collective is the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from .bucketing import BucketPlan


@dataclasses.dataclass(frozen=True)
class SyncStats:
    bytes_per_worker: int
    dense_bytes: int

    @property
    def volume_ratio(self) -> float:
        return self.dense_bytes / max(self.bytes_per_worker, 1)


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean of ``x`` over the workers of ``group``, reduced IN PLACE
    (``all_reduce`` with ``AVG``) and returned.  The identity with no
    group."""
    if group is None:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.AVG, group=group)
    return x


def start_pmean(x: torch.Tensor, group):
    """Start :func:`pmean` without waiting: ``x`` is reduced in place, and
    holds the mean once the returned work's ``wait()`` returns (on NCCL the
    wait orders the current stream after the collective and does not block
    the host).  ``None`` with no group: ``x`` already is the mean."""
    if group is None:
        return None
    return dist.all_reduce(x, op=dist.ReduceOp.AVG, group=group, async_op=True)


def flat_axis_index(group) -> int:
    """This worker's rank in ``group`` (0 with no group): the index of the
    shard it owns on the sharded sync path."""
    return 0 if group is None else dist.get_rank(group)


def reduce_scatter(x: torch.Tensor, group, *, out: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """Reduce-scatter a flat vector with the mean over ``group``: worker
    ``w`` receives the reduced shard ``x[w*S:(w+1)*S]``, ``S = len(x) / W``
    (the caller pads to a W-divisible length, ``arena.build_layout(
    align=W)``).  The shard is written into ``out`` when given.  The
    identity with no group."""
    if group is None:
        return x
    if out is None:
        out = torch.empty(x.numel() // dist.get_world_size(group), dtype=x.dtype,
                          device=x.device)
    start_reduce_scatter(x, group, out=out).wait()
    return out


def start_reduce_scatter(x: torch.Tensor, group, *, out: torch.Tensor):
    """Start :func:`reduce_scatter` over ``group`` into ``out`` without
    waiting; returns the work."""
    W = dist.get_world_size(group)
    if x.numel() % W:
        raise ValueError(f"reduce_scatter: {x.numel()} elements do not split "
                         f"into {W} shards")
    return dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.AVG, group=group,
                                      async_op=True)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Gather ``x`` from every worker along a new leading axis:
    ``(W, *x.shape)`` in rank order, through one ``all_gather_into_tensor``
    into a ``(W*n,)`` buffer.  A 1-byte dtype (int8, float8) goes on the wire
    as a ``uint8`` view, which every backend carries (gloo refuses float8).
    With no group, ``x`` with a leading axis of 1."""
    if group is None:
        return x.unsqueeze(0)
    flat = x.contiguous().reshape(-1)
    wire = flat.view(torch.uint8) if flat.element_size() == 1 else flat
    out = torch.empty(dist.get_world_size(group) * wire.numel(),
                      dtype=wire.dtype, device=wire.device)
    dist.all_gather_into_tensor(out, wire, group=group)
    return out.view(x.dtype).view(-1, *x.shape)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Exchange the rows of ``x`` (shape ``(W, ...)``): row ``w`` goes to
    worker ``w``, and row ``w`` of the result is what worker ``w`` sent
    this one (``lax.all_to_all`` with ``split_axis = concat_axis = 0``),
    through one ``all_to_all_single``, which NCCL and gloo both run.  A
    1-byte dtype goes on the wire as a ``uint8`` view, as in
    :func:`all_gather`.  The identity with no group."""
    if group is None:
        return x
    W = dist.get_world_size(group)
    if x.shape[0] != W:
        raise ValueError(f"all_to_all: leading axis {x.shape[0]} is not the "
                         f"world size {W}")
    flat = x.contiguous().reshape(-1)
    wire = flat.view(torch.uint8) if flat.element_size() == 1 else flat
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    return out.view(x.dtype).view(x.shape)


def start_all_gather_tiled(shard: torch.Tensor, group):
    """Start a concatenating all-gather of per-worker shards (worker order =
    rank, the inverse of :func:`reduce_scatter`'s scatter) and return
    ``(out, work)``: ``out`` holds the gathered vector once ``work.wait()``
    returns (on NCCL the wait orders the current stream after the gather
    and does not block the host)."""
    out = torch.empty(dist.get_world_size(group) * shard.numel(),
                      dtype=shard.dtype, device=shard.device)
    return out, dist.all_gather_into_tensor(out, shard, group=group, async_op=True)


class Compressor:
    """Base class.  Subclasses set ``name`` and implement the plan/execute
    pair (``plan_phase`` + ``execute``)."""

    name: str = "base"

    def __init__(self, **kw):
        self.options = dict(kw)

    def init_state(self, params: list[torch.Tensor], plan: BucketPlan) -> Any:
        return ()

    def num_phases(self) -> int:
        """How many phase-specialised step functions the trainer builds."""
        return 1

    def plan_phase(self, plan: BucketPlan, phase: int, *, world: int = 1):
        raise NotImplementedError

    def execute(self, schedule, grads: list[torch.Tensor], state: Any, *,
                step: int = 0, group=None):
        raise NotImplementedError

    def __repr__(self):
        opts = ", ".join(f"{k}={v}" for k, v in self.options.items())
        return f"{type(self).__name__}({opts})"


_REGISTRY: dict[str, Callable[..., Compressor]] = {}


def register(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_compressor(name: str, **kw) -> Compressor:
    if name not in _REGISTRY:
        raise KeyError(
            f"compressor {name!r} is not ported; have {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](**kw)


def dense_bytes(plan: BucketPlan) -> int:
    return sum(b.nbytes for b in plan.buckets)
