"""The deferred half of sharded sync (the ``supports_sharded_sync`` and
``sharded_param_allgather`` part of ``repro.core.overlap``; the fused
overlap hooks are not ported yet).

After a sharded step each worker's parameters are authoritative only on
the shards it owns.  The next step's head freshens them from their owners
in two halves, so the gathers ride the forward pass as the reference's
ride XLA's schedule:

* :func:`issue_param_allgather` packs every bucket's params and starts one
  asynchronous all-gather per bucket, in order of the bucket's first use
  in the forward pass (:func:`bucket_first_use`);
* :meth:`ParamGather.before_layer` waits for, and unpacks, the buckets that
  the next stage reads, where the forward pass reaches that stage.

:func:`sharded_param_allgather` is issue followed by settling every bucket;
``Trainer.flush_sync`` uses it when a run ends, since no forward follows.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import arena as ar
from . import bucketing as bk
from .comm import flat_axis_index, start_all_gather_tiled, world_size
from .schedule import CommSchedule
from .stages import SyncPipeline

# the stage of a bucket read before the embedding; stage i in [0, L) is
# layer i, and stage L the final norm and the head after the layer loop
EMBED_STAGE = -1


def supports_sharded_sync(compressor) -> bool:
    """Sharded sync needs a segmented bucket pipeline, whose wire payload
    is a dense slot view the collective can split evenly (covap / none /
    fp16)."""
    return (isinstance(compressor, SyncPipeline)
            and getattr(compressor.wire, "segmented", False))


def bucket_first_use(plan: bk.BucketPlan, num_layers: int) -> list[int]:
    """Each bucket's first-use stage in the decoder's forward pass: the
    earliest over its segments, where a stacked ``stack.blocks.*`` leaf's
    row ``r`` is read before layer ``r``, ``stack.final_norm.*`` and
    ``head.*`` after the layer loop (stage ``num_layers``), and ``embed.*``,
    or a leaf of unknown use, before the embedding (:data:`EMBED_STAGE`),
    so that nothing is read stale."""
    def first_use(seg: bk.Segment) -> int:
        path = plan.leaf_paths[seg.leaf_idx]
        if path.startswith("stack.blocks."):
            return seg.row_lo
        if path.startswith(("stack.final_norm.", "head.")):
            return num_layers
        return EMBED_STAGE

    return [min(map(first_use, bucket.segments)) for bucket in plan.buckets]


class ParamGather:
    """The head all-gather of one sharded step, in flight.

    It holds each pending bucket's work, its gathered buffer and the
    packed planes its shard was cut from, so that none is freed before its
    wait.  :meth:`settle` waits for one bucket (on NCCL the current stream
    waits, not the host) and writes its values into the leaves in place.
    The writes go through ``.data``: the settled rows are not read yet, but
    they share an autograd version counter with rows that earlier layers
    saved for the backward pass.  ``events`` records ``("issue", b)``,
    ``("settle", b)`` and ``("layer", i)`` in the order they happen."""

    def __init__(self, layout: ar.ArenaLayout, leaves: Sequence[torch.Tensor],
                 planes: list[torch.Tensor], stage: Sequence[int]):
        self.layout = layout
        self.leaves = list(leaves)
        self.planes = planes
        self.stage = list(stage)
        self.pending: dict[int, tuple[torch.Tensor, object]] = {}
        self.events: list[tuple[str, int]] = []

    def issue(self, b: int, group) -> None:
        view = self.layout.bucket_view(self.planes, b)
        W = world_size(group)
        S = view.numel() // W
        start = flat_axis_index(group)
        self.pending[b] = start_all_gather_tiled(view[start * S:(start + 1) * S],
                                                 group)
        self.events.append(("issue", b))

    @torch.no_grad()
    def settle(self, b: int) -> None:
        full, work = self.pending.pop(b)
        work.wait()
        plan = self.layout.plan
        for seg, piece in zip(plan.buckets[b].segments,
                              self.layout.unpack_bucket(b, full)):
            bk._update_segment(self.leaves[seg.leaf_idx].data, seg, piece)
        self.events.append(("settle", b))
        if not self.pending:
            self.planes = []

    def settle_through(self, stage: int) -> None:
        """Settle every pending bucket first read at ``stage`` or earlier,
        in issue order."""
        for b in [b for b in self.pending if self.stage[b] <= stage]:
            self.settle(b)

    def before_layer(self, i: int) -> None:
        """The model's callback before stage ``i``: layer ``i``, or the final
        norm and head when ``i`` is the layer count."""
        self.settle_through(i)
        self.events.append(("layer", i))

    def settle_all(self) -> None:
        self.settle_through(max(self.stage, default=EMBED_STAGE))


@torch.no_grad()
def issue_param_allgather(pipeline: SyncPipeline, schedule: CommSchedule,
                          params: Sequence[torch.Tensor], *, group,
                          first_use: Sequence[int] | None = None) -> ParamGather:
    """Start freshening EVERY bucket's parameters from their owners' shards
    (``schedule.deferred_calls``): pack each bucket's param segments into
    its W-aligned slot (at the promoted bucket dtype: params go on the wire
    uncompressed) and start one asynchronous all-gather of the locally
    owned shard per bucket, in order of ``first_use`` (each bucket's stage,
    :func:`bucket_first_use`; all at :data:`EMBED_STAGE` when ``None``).
    The gather covers the whole plan, not the previous phase's selected
    buckets: once selected, a bucket's params keep moving under the
    optimizer's moments, correctly only on the owned shard.  Any
    params-shaped list (the optimizer's moments) is gathered the same
    way.  The values land in ``params`` as the returned handle settles
    each bucket."""
    plan = schedule.plan
    W = world_size(group)
    layout = pipeline.layout(plan, align=W)
    stage = (list(first_use) if first_use is not None
             else [EMBED_STAGE] * plan.num_buckets)
    gather = ParamGather(layout, params, ar.pack_leaves(layout, params), stage)
    for b in sorted(range(plan.num_buckets), key=lambda b: (stage[b], b)):
        gather.issue(b, group)
    return gather


def sharded_param_allgather(pipeline: SyncPipeline, schedule: CommSchedule,
                            params: Sequence[torch.Tensor], *, group=None
                            ) -> list[torch.Tensor]:
    """Freshen every bucket's parameters from their owners' shards, IN
    PLACE, and return ``params``: :func:`issue_param_allgather` followed by
    settling every bucket.  The identity with no group."""
    if group is None or schedule.plan is None:
        return list(params)
    issue_param_allgather(pipeline, schedule, params, group=group).settle_all()
    return list(params)


__all__ = [
    "EMBED_STAGE",
    "ParamGather",
    "bucket_first_use",
    "issue_param_allgather",
    "sharded_param_allgather",
    "supports_sharded_sync",
]
