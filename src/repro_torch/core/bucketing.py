"""Gradient bucketing + COVAP tensor sharding (paper SS III.A / SS III.C),
the counterpart of ``repro.core.bucketing`` (plan building, segment
slicing and the overlap engine's :class:`ReadyOrder`).

A ``BucketPlan`` partitions the gradient leaves into communication
buckets, the granularity at which COVAP's coarse filter selects or skips
collectives.  Leaves are stacked over a layer axis, so the packing unit is
a **row**, one slice along axis 0 of a leaf.  Oversized buckets are split
(SS III.C) along rows or, for a single row, along its first axis >= 1.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Iterable, Sequence

import numpy as np
import torch

DEFAULT_BUCKET_BYTES = 25 * 1024 * 1024  # PyTorch DDP default (paper SS III.A)
DEFAULT_MAX_BUCKETS = 128


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous slab of one leaf: rows [row_lo, row_hi) along axis 0,
    optionally restricted to [sub_lo, sub_hi) along ``sub_axis`` (only when
    the segment covers a single row that had to be split)."""

    leaf_idx: int
    row_lo: int
    row_hi: int
    sub_axis: int | None = None
    sub_lo: int = 0
    sub_hi: int = 0

    def numel(self, shape: tuple[int, ...]) -> int:
        if not shape:
            return 1
        n = (self.row_hi - self.row_lo) * _row_numel(shape)
        if self.sub_axis is not None:
            n = n * (self.sub_hi - self.sub_lo) // shape[self.sub_axis]
        return int(n)


@dataclasses.dataclass(frozen=True)
class Bucket:
    index: int
    segments: tuple[Segment, ...]
    numel: int
    nbytes: int
    origin: int  # index of the pre-sharding bucket this came from (SS III.C)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: tuple[Bucket, ...]
    leaf_shapes: tuple[tuple[int, ...], ...]
    leaf_dtypes: tuple[torch.dtype, ...]
    leaf_paths: tuple[str, ...]
    bucket_bytes_target: int
    interval_hint: int

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def num_segments(self) -> int:
        return sum(len(b.segments) for b in self.buckets)

    def total_numel(self) -> int:
        return sum(b.numel for b in self.buckets)

    def bucket_numels(self) -> list[int]:
        return [b.numel for b in self.buckets]


def _row_count(shape: tuple[int, ...]) -> int:
    return shape[0] if shape else 1


def _row_numel(shape: tuple[int, ...]) -> int:
    return math.prod(shape[1:]) if len(shape) > 1 else 1


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _pick_sub_axis(shape: tuple[int, ...]) -> int | None:
    """First axis >= 1 that can be sliced (the port has no tensor-parallel
    sharded axes to avoid)."""
    for ax in range(1, len(shape)):
        if shape[ax] > 1:
            return ax
    return None


def build_plan(
    named_leaves: Iterable[tuple[str, Any]],
    *,
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
    max_buckets: int = DEFAULT_MAX_BUCKETS,
    interval: int = 4,
    shard_threshold: float = 2.0,
) -> BucketPlan:
    """Build the static bucket plan for ``(path, tensor)`` pairs in leaf
    order (any object with ``.shape`` and ``.dtype`` will do, meta tensors
    included).

    Pass 1 (DDP-style packing): greedily pack rows into buckets of
    ``target`` bytes; a row larger than the target becomes its own bucket.

    Pass 2 (COVAP tensor sharding, SS III.C): find the median bucket numel;
    any bucket with ``numel >= shard_threshold * median`` is evenly sliced
    into ``min(numel // median, interval)`` pieces.
    """
    named_leaves = list(named_leaves)
    paths = tuple(p for p, _ in named_leaves)
    shapes = tuple(tuple(int(d) for d in l.shape) for _, l in named_leaves)
    dtypes = tuple(l.dtype for _, l in named_leaves)
    sizes = [_itemsize(d) for d in dtypes]

    total_bytes = sum(math.prod(s) * sz for s, sz in zip(shapes, sizes))
    target = max(bucket_bytes, math.ceil(total_bytes / max_buckets))

    # ---- pass 1: DDP-style greedy packing at row granularity -------------
    raw: list[list[Segment]] = []
    raw_bytes: list[int] = []
    cur: list[Segment] = []
    cur_bytes = 0

    def flush():
        nonlocal cur, cur_bytes
        if cur:
            raw.append(cur)
            raw_bytes.append(cur_bytes)
            cur, cur_bytes = [], 0

    for li, (shape, size) in enumerate(zip(shapes, sizes)):
        rows = _row_count(shape)
        rb = _row_numel(shape) * size
        if rb >= target:
            flush()
            for r in range(rows):
                raw.append([Segment(li, r, r + 1)])
                raw_bytes.append(rb)
            continue
        r = 0
        while r < rows:
            space = target - cur_bytes
            take = max(1, min(rows - r, space // rb if rb else rows - r))
            cur.append(Segment(li, r, r + take))
            cur_bytes += take * rb
            r += take
            if cur_bytes + rb > target:
                flush()
    flush()

    # ---- pass 2: COVAP tensor sharding (SS III.C) -------------------------
    numels = [sum(s.numel(shapes[s.leaf_idx]) for s in segs) for segs in raw]
    median = int(np.median(numels)) if numels else 0
    buckets: list[Bucket] = []
    for origin, (segs, numel, nbytes) in enumerate(zip(raw, numels, raw_bytes)):
        parts = 1
        if median > 0 and numel >= shard_threshold * median:
            parts = max(int(min(numel // median, interval)), 1)
        if parts == 1:
            buckets.append(Bucket(len(buckets), tuple(segs), numel, nbytes, origin))
            continue
        for piece in _split_segments(segs, parts, shapes):
            pn = sum(s.numel(shapes[s.leaf_idx]) for s in piece)
            pb = sum(s.numel(shapes[s.leaf_idx]) * sizes[s.leaf_idx] for s in piece)
            buckets.append(Bucket(len(buckets), tuple(piece), pn, pb, origin))

    return BucketPlan(
        buckets=tuple(buckets),
        leaf_shapes=shapes,
        leaf_dtypes=dtypes,
        leaf_paths=paths,
        bucket_bytes_target=target,
        interval_hint=interval,
    )


def _split_segments(segs, parts, shapes):
    """Split a bucket's segments into ``parts`` roughly equal pieces."""
    if len(segs) == 1 and segs[0].row_hi - segs[0].row_lo == 1:
        # single row: split along a sub axis (SS III.C oversized layer)
        s = segs[0]
        shape = shapes[s.leaf_idx]
        ax = _pick_sub_axis(shape)
        if ax is None:
            return [[s]]
        dim = shape[ax]
        parts = min(parts, dim)
        bounds = np.linspace(0, dim, parts + 1, dtype=np.int64)
        out = []
        for i in range(parts):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            if hi > lo:
                out.append([Segment(s.leaf_idx, s.row_lo, s.row_hi, ax, lo, hi)])
        return out
    # multi-row bucket: split by rows, keeping segments intact where possible
    rows = [
        Segment(s.leaf_idx, r, r + 1) for s in segs for r in range(s.row_lo, s.row_hi)
    ]
    parts = min(parts, len(rows))
    bounds = np.linspace(0, len(rows), parts + 1, dtype=np.int64)
    out = [_coalesce(rows[int(bounds[i]) : int(bounds[i + 1])]) for i in range(parts)]
    return [c for c in out if c]


def _coalesce(row_segs: Sequence[Segment]) -> list[Segment]:
    out: list[Segment] = []
    for s in row_segs:
        if out and out[-1].leaf_idx == s.leaf_idx and out[-1].row_hi == s.row_lo:
            prev = out[-1]
            out[-1] = Segment(prev.leaf_idx, prev.row_lo, s.row_hi)
        else:
            out.append(s)
    return out


# ---------------------------------------------------------------------------
# runtime ops over a plan
# ---------------------------------------------------------------------------

def _slice_segment(leaf: torch.Tensor, seg: Segment) -> torch.Tensor:
    """A view of ``seg`` in ``leaf`` (a 0-d leaf becomes shape ``(1,)``)."""
    if leaf.dim() == 0:
        return leaf.reshape(1)
    x = leaf[seg.row_lo:seg.row_hi]
    if seg.sub_axis is not None:
        x = x.narrow(seg.sub_axis, seg.sub_lo, seg.sub_hi - seg.sub_lo)
    return x


def _update_segment(leaf: torch.Tensor, seg: Segment, val: torch.Tensor) -> None:
    """Write ``val`` into ``seg`` of ``leaf`` in place (cast to its dtype)."""
    dst = _slice_segment(leaf, seg)
    dst.copy_(val.reshape(dst.shape))


def segment_slices(plan: BucketPlan, leaves: Sequence[torch.Tensor], bucket: Bucket
                   ) -> list[tuple[Segment, torch.Tensor]]:
    """``(segment, view)`` pairs of a bucket, in segment order."""
    return [(seg, _slice_segment(leaves[seg.leaf_idx], seg)) for seg in bucket.segments]


# ---------------------------------------------------------------------------
# the parameters' forward layout: ReadyOrder and each bucket's first use
# ---------------------------------------------------------------------------
#
# The one reading of a leaf path: the overlap engine's readiness order, the
# fused overlap's per-row replacement tree and the sharded head all-gather's
# first-use stages all derive from this table.  A model family whose layout
# is new adds a row here, and nothing elsewhere.  A row: the stage id in
# forward order, the path markers (substrings; the first row that matches
# wins), whether the leaf is stacked over the layer loop's rows, and where
# the forward pass reads it: "before" the layer loop, in the "loop", or
# "after" it.
_Stage = collections.namedtuple("_Stage", "sid markers stacked read")
_LAYOUT = (
    _Stage(0, ("embed", "projector"), False, "before"),
    _Stage(1, ("encoder",), True, "loop"),
    _Stage(2, ("enc_norm",), False, "loop"),     # with decoder row 0
    _Stage(3, ("decoder",), True, "loop"),
    # an MoE stack's leading dense layers run before its superblocks
    _Stage(4, ("dense",), True, "loop"),
    _Stage(5, ("blocks",), True, "loop"),
    # a weight-shared block runs inside every layer, so its gradient is
    # complete with blocks row 0: it shares the blocks base
    _Stage(5, ("shared",), False, "loop"),
    _Stage(7, ("final_norm",), False, "after"),
    _Stage(8, ("head",), False, "after"),
)
# a leaf no marker names: mid-network for the readiness order, and read
# before the embedding for its first use, so that it is never read stale
_UNKNOWN = _Stage(6, (), False, "before")

# the first-use stage of a leaf read before the loop; stage i in [0, n) is
# the loop's stacked row i (encoder rows, then decoder rows; or dense rows,
# then superblocks), and stage n the final norm and the head
EMBED_STAGE = -1


def _leaf_stage(path: str) -> _Stage:
    return next((st for st in _LAYOUT if any(m in path for m in st.markers)), _UNKNOWN)


def leaf_stacked(path: str) -> bool:
    """Whether the leaf at ``path`` has one row a layer along axis 0."""
    return _leaf_stage(path).stacked


def _layout(plan: BucketPlan) -> tuple[list[_Stage], dict[int, int]]:
    """Each leaf's table row, and each stage's stacked rows (0 for none)."""
    stages = [_leaf_stage(p) for p in plan.leaf_paths]
    rows: dict[int, int] = {}
    for shape, st in zip(plan.leaf_shapes, stages):
        rows[st.sid] = max(rows.get(st.sid, 0), _row_count(shape) if st.stacked else 0)
    return stages, rows


def loop_stages(plan: BucketPlan) -> int:
    """The layer loop's stages, the plan's stacked rows: ``model.num_stages``."""
    return sum(_layout(plan)[1].values())


def bucket_first_use(plan: BucketPlan) -> list[int]:
    """Each bucket's first-use stage in the forward pass, the earliest of
    its segments': :data:`EMBED_STAGE` for a leaf read before the layer
    loop, :func:`loop_stages` for one read after it, and for one read in it
    the stacked rows of the stages before its own, plus its own row if it is
    stacked (encoder row ``r`` at ``r``, ``enc_norm`` and decoder row ``r``
    at ``E + r``; dense row ``r`` at ``r``, superblock ``r`` at ``K + r``
    and the shared block at ``K``)."""
    stages, rows = _layout(plan)

    def first_use(seg: Segment) -> int:
        st = stages[seg.leaf_idx]
        if st.read != "loop":
            return EMBED_STAGE if st.read == "before" else sum(rows.values())
        base = sum(n for sid, n in rows.items() if sid < st.sid)
        return base + (seg.row_lo if st.stacked else 0)

    return [min(map(first_use, bucket.segments)) for bucket in plan.buckets]


@dataclasses.dataclass(frozen=True)
class ReadyOrder:
    """Static backward readiness of a plan's buckets.

    ``bucket_layer[b]`` is the forward depth of the layer whose backward
    produces bucket ``b``'s last gradient; ``ranks[b]`` its issue rank (0 =
    the first bucket whose collective can start); ``order`` the buckets in
    issue order; ``num_layers`` the depth span."""

    bucket_layer: tuple[int, ...]
    ranks: tuple[int, ...]
    num_layers: int

    @property
    def order(self) -> tuple[int, ...]:
        return tuple(sorted(range(len(self.ranks)), key=lambda b: self.ranks[b]))

    def rank_of(self, bucket: int) -> int:
        return self.ranks[bucket]


def build_ready_order(plan: BucketPlan) -> ReadyOrder:
    """Buckets ranked by descending shallowest forward depth; ties (several
    buckets of one layer) go to the higher bucket index first, the reverse
    of the plan's forward packing order.  The backward pass produces
    gradients in reverse forward order, so a bucket's collective can start
    after the backward of the shallowest layer it touches.  A stacked
    leaf's row ``r`` is at depth ``stage_base + r``, every other stage
    takes one depth; a tree with no known marker takes one a leaf."""
    stages, rows = _layout(plan)
    known = any(st is not _UNKNOWN for st in stages)
    base, off = {}, 0
    for sid in sorted(rows):
        base[sid], off = off, off + max(rows[sid], 1)

    def depth(seg: Segment) -> int:
        st = stages[seg.leaf_idx]
        if not known:
            return seg.leaf_idx
        return base[st.sid] + (seg.row_lo if st.stacked else 0)

    layer = [min(map(depth, bucket.segments)) for bucket in plan.buckets]
    order = sorted(range(len(layer)), key=lambda b: (-layer[b], -b))
    ranks = [0] * len(order)
    for rank, b in enumerate(order):
        ranks[b] = rank
    return ReadyOrder(tuple(layer), tuple(ranks), max(layer) + 1 if layer else 0)
