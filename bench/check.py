"""The comparison that decides ``correct``: the first COVAP cycle of the
system under test (every bucket exchanged once) against the reference's.

Four numbers; a cell compares those its ``bench/limits/<cell>.json`` gives
a limit:

* ``loss_gap``: the largest ``|loss - loss_ref| / |loss_ref|`` over the
  cycle's steps (the loss averaged over the workers, the MoE's
  load-balance loss included);
* ``grad_gap``: the worst leaf's gap between the norm of the first
  gradient the optimizer got for each of its elements over the cycle (its
  bucket's first send, with the error feedback built up before it; read
  from AdamW's first moment, ``m / (1 - b1)``, at its first non-zero value)
  and the reference's, over the larger of the reference's norm of that leaf
  and of the median leaf it moves;
* ``grad_diff``: the worst leaf's norm of the difference between that
  gradient and the reference's, estimated from ``bench.sketch``'s random
  projections, over the same denominator (the two gradients' norms can
  agree while their elements do not: rounding errors of random sign move a
  norm to second order only);
* ``change_gap``: as ``grad_gap``, for the parameters' change over the
  cycle (the state the next cycle starts from), leaving out the leaves
  whose raw first gradient in the reference is under a thousandth of the
  median leaf's (those move by round-off alone under Adam).

With several workers every worker's leaves are compared, and the worst
counts.
"""
from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "grad_gap", "grad_diff", "change_gap")
NEGLIGIBLE = 1e-3


def _worst(diffs: list[float], norms: list[float], keep: list[bool]) -> float:
    """The largest ``diff`` over ``max(norm, the median kept non-zero
    norm)``, over the kept leaves."""
    moved = [n for n, k in zip(norms, keep) if k and n > 0]
    floor = statistics.median(moved) if moved else 0.0
    worst = 0.0
    for d, n, k in zip(diffs, norms, keep):
        if not k:
            continue
        if not math.isfinite(d):
            return math.inf
        den = max(n, floor)
        worst = max(worst, d / den if den > 0 else (0.0 if d == 0 else math.inf))
    return worst


def _leaf_gap(prog: list[float], ref: list[float], keep: list[bool]) -> float:
    return _worst([abs(p - r) for p, r in zip(prog, ref)], ref, keep)


def _sketch_gap(prog: list[list[float]], ref: list[list[float]], norms: list[float]
                ) -> float:
    diffs = [math.sqrt(sum((a - b) ** 2 for a, b in zip(p, r)) / len(r))
             for p, r in zip(prog, ref)]
    return _worst(diffs, norms, [True] * len(norms))


def gaps(progs: list[dict], ref: dict) -> dict[str, float]:
    """``progs``: each worker's ``{"loss", "grad", "sketch", "change"}``
    (lists over steps and over leaves in leaf order); ``ref``:
    :func:`bench.reference.train.run`'s."""
    raw = ref["grad_raw"]
    moved = [g for g in raw if g > 0]
    floor = NEGLIGIBLE * statistics.median(moved) if moved else 0.0
    keep_change = [g >= floor for g in raw]
    every = [True] * len(raw)
    out = {name: 0.0 for name in NAMES}
    for prog in progs:
        if len(prog["grad"]) != len(raw) or len(prog["loss"]) != len(ref["loss"]):
            raise ValueError("the program's leaves or steps differ from the reference's")
        loss = max((abs(p - r) / abs(r) if math.isfinite(p) else math.inf)
                   for p, r in zip(prog["loss"], ref["loss"]))
        out["loss_gap"] = max(out["loss_gap"], loss)
        out["grad_gap"] = max(out["grad_gap"], _leaf_gap(prog["grad"], ref["grad"], every))
        out["grad_diff"] = max(out["grad_diff"],
                               _sketch_gap(prog["sketch"], ref["sketch"], ref["grad"]))
        out["change_gap"] = max(out["change_gap"],
                                _leaf_gap(prog["change"], ref["change"], keep_change))
    return out


def verdict(found: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number the cell compares within its limit."""
    return all(math.isfinite(found[k]) and found[k] <= limit for k, limit in limits.items())
