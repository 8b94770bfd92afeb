"""The overlap engine of ``repro.core.overlap``: the fused overlap, where
each bucket's collective starts inside the backward pass (the paper's
Fig. 1(d)), and the deferred half of sharded sync.

**Fused overlap.**  :func:`install_hooks` routes every bucket's parameter
segments through one identity ``torch.autograd.Function`` (its *hook*),
whose outputs are views of the segments, never copies.  The model reads a
replacement tree built from those views (``DecoderLM.loss_fn(params=)``):
a stacked leaf as one tensor per row, so that a bucket's readiness is its
own rows' and not the whole leaf's, and a leaf or row that several buckets
split is assembled where the forward pass first reads it.  The hook's
backward receives exactly its bucket's gradient slices when the last of
them lands and calls :meth:`~repro_torch.core.stages.StepSync.start`:
EF (the ``ef_update`` kernel, or ``pack_ef_cast`` into the arena slot),
the new residual, and the collective started with ``async_op=True``.  It
never waits, and it returns no gradient for its inputs, so no ``.grad`` is
accumulated.  :func:`overlapped_loss_and_grads` waits for every bucket
after ``backward()`` returns, in issue order.

A hook is applied when the forward pass first reads one of its bucket's
segments, not before the forward pass: the autograd engine runs the ready
node that was created last first, so a hook created ahead of the forward
pass would wait behind the rest of the backward pass.  Created at the
first read, it follows every node of the earlier layers, and runs as soon
as its bucket's last gradient lands: in :class:`~.bucketing.ReadyOrder`,
with ties of equal ``bucket_layer`` going to the bucket created last.

**The deferred half of sharded sync.**  After a sharded step each worker's
parameters are authoritative only on the shards it owns.  The next step's
head freshens them from their owners in two halves, so the gathers ride
the forward pass as the reference's ride XLA's schedule:

* :func:`issue_param_allgather` packs every bucket's params and starts one
  asynchronous all-gather per bucket, in order of the bucket's first use
  in the forward pass (:func:`.bucketing.bucket_first_use`);
* :meth:`ParamGather.before_layer` waits for, and unpacks, the buckets that
  the next stage reads, where the forward pass reaches that stage.

:func:`sharded_param_allgather` is issue followed by settling every bucket;
``Trainer.flush_sync`` uses it when a run ends, since no forward follows.
Under the fused overlap the gathers are issued before the hooks are
installed, and the hooks' views read the settled values.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..obs.spans import span
from . import arena as ar
from . import bucketing as bk
from .comm import flat_axis_index, start_all_gather_tiled, world_size
from .schedule import CommSchedule
from .stages import StepSync, SyncPipeline


def supports_fused_overlap(compressor) -> bool:
    """The fused overlap needs a segmented bucket pipeline (covap / none /
    fp16): the hook's backward syncs its bucket from its raw gradient
    slices alone.  Flat wires (``fp8wire``, ``efsignsgd``, ``topk``,
    ``dgc``, ``randomk``, ``oktopk``) compensate the whole tree first, and
    the leaf path (``powersgd``) has no buckets."""
    return (isinstance(compressor, SyncPipeline)
            and compressor.granularity == "bucket"
            and getattr(compressor.wire, "segmented", False))


def supports_sharded_sync(compressor) -> bool:
    """Sharded sync needs a segmented bucket pipeline, whose wire payload
    is a dense slot view the collective can split evenly (covap / none /
    fp16): the fused overlap's requirement."""
    return supports_fused_overlap(compressor)


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
        """The model's callback before stage ``i``: superblock ``i`` (or an
        encoder-decoder's stage ``i``), or the final norm and head when
        ``i`` is ``model.num_stages``."""
        self.settle_through(i)
        self.events.append(("layer", i))

    def settle_all(self) -> None:
        self.settle_through(max(self.stage, default=bk.EMBED_STAGE))


@torch.no_grad()
def issue_param_allgather(pipeline: SyncPipeline, schedule: CommSchedule,
                          params: Sequence[torch.Tensor], *, group,
                          first_use: Sequence[int] | None = None) -> ParamGather:
    """Start freshening EVERY bucket's parameters from their owners' shards
    (``schedule.deferred_calls``): pack each bucket's param segments into
    its W-aligned slot (at the promoted bucket dtype: params go on the wire
    uncompressed) and start one asynchronous all-gather of the locally
    owned shard per bucket, in order of ``first_use`` (each bucket's stage,
    :func:`.bucketing.bucket_first_use`; all at
    :data:`.bucketing.EMBED_STAGE` when ``None``).
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
             else [bk.EMBED_STAGE] * plan.num_buckets)
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


# ---------------------------------------------------------------------------
# fused overlap
# ---------------------------------------------------------------------------

def _assert_full_coverage(plan: bk.BucketPlan) -> list:
    """Every leaf element must belong to exactly one bucket segment, the
    segments tiling each leaf in order (``arena.leaf_cover``); otherwise some
    gradient would bypass the hooks.  Returns each leaf's coverage."""
    cover = ar.leaf_cover(plan)
    for li, entries in enumerate(cover):
        if entries is None:
            raise ValueError(
                f"the bucket plan's segments do not tile leaf "
                f"{plan.leaf_paths[li]} {plan.leaf_shapes[li]}: cannot install "
                "gradient hooks")
    return cover


class _BucketHook(torch.autograd.Function):
    """The identity over one bucket's segment views; its backward starts the
    bucket's sync and returns no gradient for its inputs."""

    @staticmethod
    def forward(ctx, hooks, b, anchor, *xs):
        ctx.hooks, ctx.b = hooks, b
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.hooks.fire(ctx.b, grads)
        # the hooks hold this node's outputs: drop the way back, so that the
        # step's sync is freed when the step ends, not at the next gc cycle
        ctx.hooks = None
        return (None, None, None) + (None,) * len(grads)


class BucketHooks:
    """One step's bucket hooks over ``leaves``, applied lazily (see the
    module notes) and fired by the backward pass.

    ``fired`` lists the buckets in the order their hooks fired; ``streams``
    the CUDA stream each hook's backward ran on (``None`` off the card), and
    ``forward_stream`` the stream current when the hooks were installed.
    Each fire runs inside ``span(f"covap_bucket_{b}/phase_{p}")``
    (``obs.spans``), the reference's ``named_scope`` name, so a profiler
    trace shows each bucket's issue."""

    def __init__(self, sync: StepSync, leaves: Sequence[torch.Tensor]):
        self.sync = sync
        self.leaves = list(leaves)
        self.plan = sync.plan
        self.phase = sync.schedule.phase
        dev = self.leaves[0].device
        # an input that requires grad, so the hooks' outputs do; the
        # segments themselves are detached views
        self.anchor = torch.zeros((), device=dev, requires_grad=True)
        self.outputs: dict[int, tuple[torch.Tensor, ...]] = {}
        self.fired: list[int] = []
        self.streams: list[int | None] = []
        self.forward_stream = (torch.cuda.current_stream(dev).cuda_stream
                               if dev.type == "cuda" else None)

    def piece(self, b: int, si: int) -> torch.Tensor:
        """Segment ``si`` of bucket ``b`` through its hook, applied on the
        first request."""
        if b not in self.outputs:
            segs = self.plan.buckets[b].segments
            xs = [bk._slice_segment(self.leaves[s.leaf_idx].detach(), s) for s in segs]
            self.outputs[b] = _BucketHook.apply(self, b, self.anchor, *xs)
        return self.outputs[b][si]

    def fire(self, b: int, grads) -> None:
        sync = self.sync
        if sync.ef_on or b in sync.selected:
            with span(f"covap_bucket_{b}/phase_{self.phase}"):
                sync.start(b, list(grads))
        self.fired.append(b)
        self.streams.append(torch.cuda.current_stream(grads[0].device).cuda_stream
                            if grads[0].is_cuda else None)


def _row_blocks(entries) -> list[tuple[int, int, list]]:
    """A leaf's ordered coverage grouped by row block: ``(row_lo, row_hi,
    [(b, si, seg), ...])``, one entry, or the sub-axis pieces of one block."""
    blocks: list[tuple[int, int, list]] = []
    for b, si, seg in entries:
        if blocks and (blocks[-1][0], blocks[-1][1]) == (seg.row_lo, seg.row_hi) \
                and seg.sub_axis is not None:
            blocks[-1][2].append((b, si, seg))
        else:
            blocks.append((seg.row_lo, seg.row_hi, [(b, si, seg)]))
    return blocks


class _Deferred:
    """A leaf or row assembled when first read, then kept for the step.
    Called with a dtype (``models.transformer.resolve``), it assembles the
    pieces cast to it: a leaf that several buckets split is joined at the
    dtype the model computes in, as the module's leaf would be cast, and no
    copy at the parameter dtype is made."""

    def __init__(self, make):
        self.make, self.values = make, {}

    def __call__(self, dtype=None) -> torch.Tensor:
        if dtype not in self.values:
            self.values[dtype] = self.make(dtype)
        return self.values[dtype]


def _cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


def _block(hooks: BucketHooks, pieces, dtype=None) -> torch.Tensor:
    """A row block from its pieces: the one segment, or the sub-axis
    pieces joined along their axis."""
    if len(pieces) == 1:
        return _cast(hooks.piece(*pieces[0][:2]), dtype)
    return torch.cat([_cast(hooks.piece(b, si), dtype) for b, si, _ in pieces],
                     dim=pieces[0][2].sub_axis)


def _replacement(hooks: BucketHooks, li: int, entries, stacked: bool):
    """Leaf ``li``'s entry in the replacement tree: per-row deferred tensors
    for a leaf stacked over layers, else one deferred tensor."""
    shape = hooks.plan.leaf_shapes[li]
    blocks = _row_blocks(entries)
    if not shape:
        return _Deferred(lambda dt: _block(hooks, blocks[0][2], dt).reshape(()))
    if not stacked:
        if len(blocks) == 1:
            return _Deferred(lambda dt: _block(hooks, blocks[0][2], dt))
        return _Deferred(lambda dt: torch.cat([_block(hooks, p, dt)
                                               for _, _, p in blocks]))
    rows: list = []
    for lo, hi, pieces in blocks:
        unbound = _Deferred(lambda dt, p=pieces: _block(hooks, p, dt).unbind(0))
        rows.extend(_Deferred(lambda dt, u=unbound, k=k: u(dt)[k])
                    for k in range(hi - lo))
    return rows


def install_hooks(sync: StepSync, leaves: Sequence[torch.Tensor]) -> dict:
    """The replacement tree of ``leaves`` (the parameters, in leaf order)
    through ``sync``'s bucket hooks, nested by path for
    ``DecoderLM.loss_fn(params=)``, and its :class:`BucketHooks`: ``(tree,
    hooks)``.  Forward values are the leaves' own.  A leaf of a stacked
    stage (:func:`.bucketing.leaf_stacked`) becomes a list of
    per-row entries; every entry is deferred (``models.transformer.resolve``)
    until the forward pass reads it."""
    plan = sync.plan
    cover = _assert_full_coverage(plan)
    hooks = BucketHooks(sync, leaves)
    tree: dict = {}
    for li, path in enumerate(plan.leaf_paths):
        *heads, last = path.split(".")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = _replacement(hooks, li, cover[li], bk.leaf_stacked(path))
    return tree, hooks


def overlapped_loss_and_grads(model, pipeline: SyncPipeline, schedule: CommSchedule,
                              params: Sequence[torch.Tensor], comp_state, batch, step: int,
                              *, group=None, before_layer=None):
    """The fused step's core: forward through the hooks, ``backward()``
    (each bucket's sync starts inside it), then every bucket's wait, in
    issue order.  -> ``(loss, metrics, synced, new_comp_state, sync,
    hooks)``: the contract of :func:`~repro_torch.train.loss_and_grads`
    followed by ``pipeline.execute``, with the same values (``metrics`` not
    yet averaged over the group), then the step's :class:`StepSync` (its
    ``events``) and :class:`BucketHooks` (``fired``, ``streams``).  With EF
    off an unselected bucket's synced gradient stays zero."""
    if not supports_fused_overlap(pipeline):
        raise ValueError(
            f"fused overlap supports segmented bucket pipelines (covap / none / "
            f"fp16); got {pipeline!r}: use overlap='post'")
    sync = StepSync(pipeline, schedule, params, comp_state, step=step, group=group)
    tree, hooks = install_hooks(sync, params)
    with span("train/forward"):
        total, metrics = model.loss_fn(batch, before_layer=before_layer, params=tree)
    with span("train/backward"):
        total.backward()
    hooks.outputs.clear()
    sync.events.append(("backward_done", -1))
    with span("train/sync"):
        for b in list(sync.started):
            sync.finish(b)
        synced, new_state = sync.close()
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, synced, new_state, sync, hooks


__all__ = [
    "BucketHooks",
    "ParamGather",
    "install_hooks",
    "issue_param_allgather",
    "overlapped_loss_and_grads",
    "sharded_param_allgather",
    "supports_fused_overlap",
    "supports_sharded_sync",
]
