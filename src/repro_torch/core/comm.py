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
