"""COVAP's gradient exchange, plain: the bucket plan, the coarse filter and
error feedback with its rising coefficient, the mean over workers, and
AdamW.

The plan packs the leaves, in leaf order, row by row (a row is one slice
along a leaf's first axis) into buckets of ``target = max(bucket_bytes,
ceil(total_bytes / max_buckets))`` bytes, a row of ``target`` bytes or more
alone in its own bucket; then every bucket of at least twice the median
bucket's elements is cut into ``min(elements // median, interval)`` even
pieces: by rows, or along the first axis after the row axis for a single
row.  Bucket ``b`` is exchanged at step ``s`` when ``(b + s) % I == 0``.

Per worker and step, with ``c(s) = min(0.3 + floor(s / 200) * 0.1, 1)``
in float32: ``t = g + c * r``; an exchanged bucket sends ``t`` and keeps
``r = 0``, any other sends nothing and keeps ``r = t``.  The optimizer
gets the mean of the sends over the workers where a bucket was exchanged,
and zero elsewhere.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Segment:
    leaf: int
    row_lo: int
    row_hi: int
    axis: int | None = None
    lo: int = 0
    hi: int = 0

    def numel(self, shape) -> int:
        n = (self.row_hi - self.row_lo) * math.prod(shape[1:])
        if self.axis is not None:
            n = n * (self.hi - self.lo) // shape[self.axis]
        return n

    def view(self, leaf: torch.Tensor) -> torch.Tensor:
        x = leaf[self.row_lo:self.row_hi]
        if self.axis is not None:
            x = x.narrow(self.axis, self.lo, self.hi - self.lo)
        return x


def plan_buckets(shapes: list[tuple[int, ...]], *, bucket_bytes: int, max_buckets: int,
                 interval: int, itemsize: int = 4, shard_threshold: float = 2.0
                 ) -> list[list[Segment]]:
    """The buckets of leaves of ``shapes`` (leaf order, one dtype), each a
    list of segments."""
    total = sum(math.prod(s) for s in shapes) * itemsize
    target = max(bucket_bytes, math.ceil(total / max_buckets))
    raw: list[list[Segment]] = []
    cur: list[Segment] = []
    cur_bytes = 0
    for li, shape in enumerate(shapes):
        rows = shape[0] if shape else 1
        rb = math.prod(shape[1:]) * itemsize
        if rb >= target:
            if cur:
                raw.append(cur)
                cur, cur_bytes = [], 0
            raw.extend([[Segment(li, r, r + 1)] for r in range(rows)])
            continue
        r = 0
        while r < rows:
            take = max(1, min(rows - r, (target - cur_bytes) // rb))
            cur.append(Segment(li, r, r + take))
            cur_bytes += take * rb
            r += take
            if cur_bytes + rb > target:
                raw.append(cur)
                cur, cur_bytes = [], 0
    if cur:
        raw.append(cur)
    numels = [sum(s.numel(shapes[s.leaf]) for s in segs) for segs in raw]
    median = int(np.median(numels)) if numels else 0
    out: list[list[Segment]] = []
    for segs, n in zip(raw, numels):
        parts = 1
        if median > 0 and n >= shard_threshold * median:
            parts = max(int(min(n // median, interval)), 1)
        out.extend([segs] if parts == 1 else _split(segs, parts, shapes))
    return out


def _split(segs, parts, shapes):
    if len(segs) == 1 and segs[0].row_hi - segs[0].row_lo == 1:
        s = segs[0]
        shape = shapes[s.leaf]
        axis = next((ax for ax in range(1, len(shape)) if shape[ax] > 1), None)
        if axis is None:
            return [[s]]
        parts = min(parts, shape[axis])
        bounds = np.linspace(0, shape[axis], parts + 1, dtype=np.int64)
        return [[Segment(s.leaf, s.row_lo, s.row_hi, axis, int(lo), int(hi))]
                for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
    rows = [Segment(s.leaf, r, r + 1) for s in segs for r in range(s.row_lo, s.row_hi)]
    parts = min(parts, len(rows))
    bounds = np.linspace(0, len(rows), parts + 1, dtype=np.int64)
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        merged: list[Segment] = []
        for s in rows[int(lo):int(hi)]:
            if merged and merged[-1].leaf == s.leaf and merged[-1].row_hi == s.row_lo:
                merged[-1] = Segment(s.leaf, merged[-1].row_lo, s.row_hi)
            else:
                merged.append(s)
        if merged:
            out.append(merged)
    return out


def exchanged(bucket: int, step: int, interval: int) -> bool:
    return interval <= 1 or (bucket + step) % interval == 0


def ef_coefficient(step: int, init: float = 0.3, ascend_steps: int = 200,
                   ascend_range: float = 0.1) -> float:
    s = np.float32(step)
    c = np.float32(init) + np.floor(s / np.float32(ascend_steps)) * np.float32(ascend_range)
    return float(np.minimum(c, np.float32(1.0)))


@torch.no_grad()
def exchange(buckets, grads: list[list[torch.Tensor]], residuals: list[list[torch.Tensor]],
             step: int, interval: int) -> list[torch.Tensor]:
    """One step of the exchange over ``W`` workers: ``grads[w]`` and
    ``residuals[w]`` are worker ``w``'s leaves; the residuals are updated in
    place.  Returns the gradient the optimizer gets, in leaf order."""
    c = ef_coefficient(step)
    out = [torch.zeros_like(g) for g in grads[0]]
    W = len(grads)
    for b, segs in enumerate(buckets):
        sent = exchanged(b, step, interval)
        for seg in segs:
            total = None
            for w in range(W):
                r = seg.view(residuals[w][seg.leaf])
                t = seg.view(grads[w][seg.leaf]) + c * r
                if sent:
                    total = t.clone() if total is None else total + t
                    r.zero_()
                else:
                    r.copy_(t)
            if sent:
                seg.view(out[seg.leaf]).copy_(total / W)
    return out


class AdamW:
    """Adam with decoupled weight decay, float32 moments, a constant rate."""

    def __init__(self, params: list[torch.Tensor], lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.wd:
                u = u + self.wd * p
            p.add_(u, alpha=-self.lr)
