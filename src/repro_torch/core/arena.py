"""Zero-copy gradient arena: statically planned flat bucket buffers (the
counterpart of ``repro.core.arena``).

An :class:`ArenaLayout` gives every covered bucket a contiguous slot in
one flat per-dtype buffer (a *plane*), with per-segment offsets computed
once from the :class:`~repro_torch.core.bucketing.BucketPlan`.  At execute
time the pack pass writes each segment's wire values straight into its
range of the plane (the ``pack_ef_cast`` kernel takes that range as its
output), every bucket's collective runs in place on a slice view of the
plane, and the synced values go back to the leaves through static slices.

Layout rules, as in the reference:

* buckets in plan order, one slot each, segments back to back in segment
  order;
* a bucket's element type is its promoted dtype (:func:`bucket_dtype`)
  unless the caller pins a wire dtype (the ``WireCast`` cast);
* one plane per dtype;
* the layout covers a caller-chosen bucket subset (a phase's selected
  buckets), so an unselected bucket has no slot;
* ``align`` (sharded sync) rounds each slot's extent up to a multiple of
  the world size; the tail is zero on every step, because it is reduced
  like payload.

Planes come from ``torch.empty``: every element of a slot is written by the
pack, and the aligned tails are zeroed explicitly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Sequence

import torch

from . import bucketing as bk
from .bucketing import Bucket, BucketPlan


def bucket_dtype(plan: BucketPlan, bucket: Bucket) -> torch.dtype:
    """Dtype of the flattened bucket (mixed buckets promote)."""
    dt = plan.leaf_dtypes[bucket.segments[0].leaf_idx]
    for s in bucket.segments[1:]:
        dt = torch.promote_types(dt, plan.leaf_dtypes[s.leaf_idx])
    return dt


def segment_shape(plan: BucketPlan, seg: bk.Segment) -> tuple[int, ...]:
    """Shape of one segment's slice of its leaf (scalars -> ``(1,)``)."""
    shape = plan.leaf_shapes[seg.leaf_idx]
    if not shape:
        return (1,)
    out = list(shape)
    out[0] = seg.row_hi - seg.row_lo
    if seg.sub_axis is not None:
        out[seg.sub_axis] = seg.sub_hi - seg.sub_lo
    return tuple(out)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class ArenaLayout:
    """Static flat-buffer layout for a subset of a plan's buckets.

    ``buckets[i]`` is covered bucket *i* (plan order); the parallel tuples
    give its plane, element offset within the plane and extent (padded to
    ``align``).  ``seg_offsets[i]`` holds the plane offset of each of its
    segments.  ``plane_dtypes`` are dtype names, as in the reference."""

    plan: BucketPlan
    buckets: tuple[int, ...]
    plane_dtypes: tuple[str, ...]
    plane_sizes: tuple[int, ...]
    bucket_plane: tuple[int, ...]
    bucket_offsets: tuple[int, ...]
    bucket_numels: tuple[int, ...]
    seg_offsets: tuple[tuple[int, ...], ...]
    align: int = 1

    def __post_init__(self):
        object.__setattr__(self, "_pos", {b: i for i, b in enumerate(self.buckets)})

    # ---- lookups ----------------------------------------------------------
    def slot(self, b: int) -> tuple[int, int, int]:
        """-> (plane index, element offset, extent) of bucket ``b``."""
        i = self._pos[b]
        return self.bucket_plane[i], self.bucket_offsets[i], self.bucket_numels[i]

    def nbytes(self) -> int:
        return sum(
            n * torch.empty((), dtype=getattr(torch, d)).element_size()
            for n, d in zip(self.plane_sizes, self.plane_dtypes)
        )

    # ---- buffers ----------------------------------------------------------
    def empty_planes(self, device) -> list[torch.Tensor]:
        """Uninitialised planes, with every slot's aligned tail zeroed: the
        caller writes each segment's range (``segment_view``)."""
        planes = [
            torch.empty(n, dtype=getattr(torch, d), device=device)
            for n, d in zip(self.plane_sizes, self.plane_dtypes)
        ]
        for b in self.buckets:
            p, off, extent = self.slot(b)
            real = self.plan.buckets[b].numel
            if extent > real:
                planes[p][off + real:off + extent].zero_()
        return planes

    def bucket_view(self, planes: Sequence[torch.Tensor], b: int) -> torch.Tensor:
        """Bucket ``b``'s payload: a slice view of its plane, not a copy."""
        p, off, n = self.slot(b)
        return planes[p][off:off + n]

    def segment_view(self, planes: Sequence[torch.Tensor], b: int,
                     si: int) -> torch.Tensor:
        """The flat range of segment ``si`` of bucket ``b`` in its plane."""
        i = self._pos[b]
        seg = self.plan.buckets[b].segments[si]
        off = self.seg_offsets[i][si]
        n = seg.numel(self.plan.leaf_shapes[seg.leaf_idx])
        return planes[self.bucket_plane[i]][off:off + n]

    def assemble(self, pieces: dict[int, Sequence[torch.Tensor]],
                 device=None) -> list[torch.Tensor]:
        """Build the planes from per-bucket segment pieces.

        ``pieces[b]`` holds bucket ``b``'s per-segment values (any shape;
        flattened and cast to the plane dtype as they are written).  Each
        piece is copied once into its preallocated range; buckets the
        layout does not cover are ignored, and every covered bucket must be
        present."""
        if device is None:
            device = next((v.device for vs in pieces.values() for v in vs), "cpu")
        planes = self.empty_planes(device)
        for b in self.buckets:
            vals = pieces[b]
            segs = self.plan.buckets[b].segments
            if len(vals) != len(segs):
                raise ValueError(
                    f"bucket {b}: {len(vals)} pieces for {len(segs)} segments"
                )
            for si, v in enumerate(vals):
                self.segment_view(planes, b, si).copy_(v.reshape(-1))
        return planes

    def unpack_bucket(self, b: int, flat: torch.Tensor) -> list[torch.Tensor]:
        """Split a bucket-sized flat vector into segment-shaped views."""
        i = self._pos[b]
        plan = self.plan
        base = self.bucket_offsets[i]
        out = []
        for seg, off in zip(plan.buckets[b].segments, self.seg_offsets[i]):
            shape = segment_shape(plan, seg)
            n = math.prod(shape)
            out.append(flat[off - base:off - base + n].view(shape))
        return out


def aligned_numel(numel: int, align: int) -> int:
    """Slot extent of a bucket under W-aligned padding: the element count
    that crosses the wire on the sharded path."""
    align = max(int(align), 1)
    return -(-int(numel) // align) * align


def build_layout(
    plan: BucketPlan,
    selected: Iterable[int] | None = None,
    *,
    wire_dtype: torch.dtype | None = None,
    align: int = 1,
) -> ArenaLayout:
    """The static arena layout for ``selected`` buckets (default: every
    bucket), from plan metadata alone.

    ``wire_dtype`` pins every bucket's element type; otherwise each bucket
    uses its :func:`bucket_dtype`.  ``align`` rounds every slot's extent up
    to a multiple (the DP world size under sharded sync)."""
    if selected is None:
        covered = list(range(plan.num_buckets))
    else:
        covered = sorted(dict.fromkeys(int(b) for b in selected))
    align = max(int(align), 1)

    plane_of: dict[str, int] = {}
    plane_dtypes: list[str] = []
    plane_sizes: list[int] = []
    bucket_plane: list[int] = []
    bucket_offsets: list[int] = []
    bucket_numels: list[int] = []
    seg_offsets: list[tuple[int, ...]] = []

    for b in covered:
        bucket = plan.buckets[b]
        name = _dtype_name(wire_dtype if wire_dtype is not None
                           else bucket_dtype(plan, bucket))
        if name not in plane_of:
            plane_of[name] = len(plane_dtypes)
            plane_dtypes.append(name)
            plane_sizes.append(0)
        p = plane_of[name]
        off = plane_sizes[p]
        offs = []
        cur = off
        for seg in bucket.segments:
            offs.append(cur)
            cur += seg.numel(plan.leaf_shapes[seg.leaf_idx])
        if cur - off != bucket.numel:
            raise ValueError(f"bucket {b}: segments cover {cur - off} of "
                             f"{bucket.numel} elements")
        extent = aligned_numel(bucket.numel, align)
        bucket_plane.append(p)
        bucket_offsets.append(off)
        bucket_numels.append(extent)
        seg_offsets.append(tuple(offs))
        plane_sizes[p] = off + extent

    return ArenaLayout(
        plan=plan,
        buckets=tuple(covered),
        plane_dtypes=tuple(plane_dtypes),
        plane_sizes=tuple(plane_sizes),
        bucket_plane=tuple(bucket_plane),
        bucket_offsets=tuple(bucket_offsets),
        bucket_numels=tuple(bucket_numels),
        seg_offsets=tuple(seg_offsets),
        align=align,
    )


def pack_leaves(layout: ArenaLayout, leaves: Sequence[torch.Tensor]
                ) -> list[torch.Tensor]:
    """Pack leaf tensors into arena planes: every covered bucket's segment
    slices land at their planned offsets (cast to the plane dtype), so a
    ``bucket_view`` is the bucket's flat vector in segment order."""
    pieces = {
        b: [bk._slice_segment(leaves[seg.leaf_idx], seg)
            for seg in layout.plan.buckets[b].segments]
        for b in layout.buckets
    }
    device = leaves[0].device if leaves else None
    return layout.assemble(pieces, device=device)


def leaf_cover(plan: BucketPlan) -> list[list[tuple[int, int, bk.Segment]] | None]:
    """Per-leaf ordered ``(bucket, seg_pos, Segment)`` coverage.

    ``build_plan`` tiles every leaf with ascending contiguous row (and
    sub-axis) ranges in bucket order.  A leaf whose coverage is not such a
    tiling yields ``None``."""
    cover: list[list[tuple[int, int, bk.Segment]]] = [[] for _ in plan.leaf_shapes]
    for b, bucket in enumerate(plan.buckets):
        for si, seg in enumerate(bucket.segments):
            cover[seg.leaf_idx].append((b, si, seg))
    out: list[list[tuple[int, int, bk.Segment]] | None] = []
    for li, entries in enumerate(cover):
        shape = plan.leaf_shapes[li]
        rows = shape[0] if shape else 1
        ok = bool(entries)
        r = 0
        i = 0
        while ok and i < len(entries):
            seg = entries[i][2]
            if seg.row_lo != r:
                ok = False
                break
            if seg.sub_axis is None:
                r = seg.row_hi
                i += 1
                continue
            # a run of sub-axis splits of one row block must tile the axis
            dim = shape[seg.sub_axis]
            c = 0
            while i < len(entries):
                s2 = entries[i][2]
                if (s2.row_lo != seg.row_lo or s2.sub_axis != seg.sub_axis
                        or s2.sub_lo != c):
                    break
                c = s2.sub_hi
                i += 1
            if c != dim:
                ok = False
            r = seg.row_hi
        out.append(entries if ok and r == rows else None)
    return out


def empty_leaves(plan: BucketPlan, like: Sequence[torch.Tensor]
                 ) -> list[torch.Tensor]:
    """Fresh leaves shaped like ``like`` for a pass that writes every
    segment of the plan: uninitialised where :func:`leaf_cover` shows that
    the segments tile the leaf, zeros otherwise."""
    return [
        (torch.empty_like if entries is not None else torch.zeros_like)(ref)
        for ref, entries in zip(like, leaf_cover(plan))
    ]


@torch.no_grad()
def gather_leaves(
    plan: BucketPlan,
    piece: Callable[[int, int, bk.Segment], torch.Tensor | None],
    like: Sequence[torch.Tensor],
    out: Sequence[torch.Tensor] | None = None,
) -> list[torch.Tensor]:
    """Reassemble full leaves from per-segment pieces, the inverse of
    :func:`pack_leaves`.

    ``piece(b, si, seg)`` returns the segment-shaped value of segment
    ``si`` of bucket ``b``, or ``None`` for zeros (an unselected bucket).
    Each value is written once into its slice of the leaf, cast to the
    leaf's dtype.  The leaves are ``out`` when given (written in place),
    else fresh tensors shaped like ``like``: uninitialised where
    :func:`leaf_cover` shows that the segments tile the leaf, zeros
    otherwise."""
    if out is None:
        out = empty_leaves(plan, like)
    for b, bucket in enumerate(plan.buckets):
        for si, seg in enumerate(bucket.segments):
            dst = bk._slice_segment(out[seg.leaf_idx], seg)
            v = piece(b, si, seg)
            if v is None:
                dst.zero_()
            else:
                dst.copy_(v.reshape(dst.shape))
    return list(out)


__all__ = [
    "ArenaLayout",
    "aligned_numel",
    "bucket_dtype",
    "build_layout",
    "empty_leaves",
    "gather_leaves",
    "leaf_cover",
    "pack_leaves",
    "segment_shape",
]
