"""The deferred half of sharded sync (the ``supports_sharded_sync`` and
``sharded_param_allgather`` part of ``repro.core.overlap``; the fused
overlap hooks are not ported yet).

After a sharded step each worker's parameters are authoritative only on
the shards it owns, so the trainer calls :func:`sharded_param_allgather`
at the head of the next step, before the forward pass reads any
parameter, and once more when a run ends (``Trainer.flush_sync``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import arena as ar
from .comm import all_gather_tiled, flat_axis_index, world_size
from .schedule import CommSchedule
from .stages import SyncPipeline


def supports_sharded_sync(compressor) -> bool:
    """Sharded sync needs a segmented bucket pipeline, whose wire payload
    is a dense slot view the collective can split evenly (covap / none /
    fp16)."""
    return (isinstance(compressor, SyncPipeline)
            and getattr(compressor.wire, "segmented", False))


@torch.no_grad()
def sharded_param_allgather(pipeline: SyncPipeline, schedule: CommSchedule,
                            params: Sequence[torch.Tensor], *, group=None
                            ) -> list[torch.Tensor]:
    """Freshen EVERY bucket's parameters from their owners' shards
    (``schedule.deferred_calls``), IN PLACE, and return ``params``.

    Each bucket's param segments are packed into its W-aligned slot (at
    the promoted bucket dtype: params go on the wire uncompressed), the
    locally owned shard is all-gathered (``comm.all_gather_tiled``), and
    the gathered values are written back into the leaves.  The gather
    covers the whole plan, not the previous phase's selected buckets:
    once selected, a bucket's params keep moving under the optimizer's
    moments, correctly only on the owned shard.  Any params-shaped list
    (the optimizer's moments) is gathered the same way.  The identity with
    no group."""
    if group is None or schedule.plan is None:
        return list(params)
    plan = schedule.plan
    W = world_size(group)
    start = flat_axis_index(group)
    layout = pipeline.layout(plan, align=W)
    planes = ar.pack_leaves(layout, params)
    fresh = {}
    for b in range(plan.num_buckets):
        view = layout.bucket_view(planes, b)
        S = view.numel() // W
        full = all_gather_tiled(view[start * S:(start + 1) * S], group)
        fresh[b] = layout.unpack_bucket(b, full)
    return ar.gather_leaves(plan, lambda b, si, seg: fresh[b][si], params,
                            out=params)


__all__ = ["sharded_param_allgather", "supports_sharded_sync"]
