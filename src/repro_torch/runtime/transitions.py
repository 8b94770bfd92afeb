"""Safe re-plan boundaries: carrying compressor state across a plan switch
(the counterpart of ``repro.runtime.transitions``).

A re-plan changes the interval ``I``, and with it the bucket plan (COVAP's
tensor sharding slices oversized buckets into ``min(., I)`` pieces).  The
error-feedback residual is parameter-structured, not bucket-structured: it
is exactly the gradient mass not yet communicated, and the paper's accuracy
argument (SS III.D) needs only that mass conserved.  So the default policy
is ``"carry"``: the residual tensors move to the new plan untouched, and
their global norm is preserved bit for bit.

Policies:

* ``"carry"``: keep the residuals as they are (default; norm preserved);
* ``"rescale"``: when the cadence shortens (``new_I < old_I``), scale the
  residuals by ``new_I / old_I``: the compensation now drains the buffer
  over fewer steps, and the damping avoids a one-time over-compensation
  right after the switch;
* ``"flush"``: zero the residuals (the conservative reset; the dropped
  norm is reported so that callers can log the accuracy cost).

A structure change (EF turning on or off at ``I = 1``, or another state
family) falls back to re-initialising from the new compressor, with the
dropped norm reported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class TransitionReport:
    """What happened to the compressor state at one re-plan boundary."""

    step: int
    old_interval: int
    new_interval: int
    policy: str                 # "carry" | "rescale" | "flush" | "reinit"
    norm_before: float
    norm_after: float

    @property
    def norm_dropped(self) -> float:
        return max(0.0, self.norm_before - self.norm_after)

    def summary(self) -> dict:
        return dataclasses.asdict(self)


def _tensors(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def residual_norm(comp_state: Any) -> float:
    """Global L2 norm of every floating tensor of a compressor state.

    Handles the three state shapes of the port: ``()`` (no EF), a residual
    list in leaf order (COVAP and the flat wires), and PowerSGD's ``{"q":
    [...], "residual": [...]}`` with ``None`` holes, of which only the
    ``residual`` half counts (``q`` is a sketch, not deferred gradient).
    The squares are summed in float32 on the state's device, and the
    device is synced once for the whole tree."""
    if isinstance(comp_state, dict) and "residual" in comp_state:
        comp_state = comp_state["residual"]
    total = None
    for leaf in _tensors(comp_state):
        if leaf.is_floating_point():
            sq = torch.sum(torch.square(leaf.float()))
            total = sq if total is None else total + sq
    if total is None:
        return 0.0
    return math.sqrt(float(total))


def _structure(tree: Any):
    """The tree's shape: containers, ``None`` holes and tensor shapes."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape))
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in sorted(tree.items())))
    if isinstance(tree, (list, tuple)):
        return ("seq", tuple(_structure(v) for v in tree))
    return ("leaf", tree)


def _same_structure(a: Any, b: Any) -> bool:
    return _structure(a) == _structure(b)


def _scaled(tree: Any, factor: float) -> Any:
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            return (tree.float() * factor).to(tree.dtype)
        return tree
    if isinstance(tree, dict):
        return {k: _scaled(v, factor) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_scaled(v, factor) for v in tree)
    return tree


def carry_comp_state(
    comp_state: Any,
    *,
    new_compressor,
    new_plan,
    params_like: Any,
    step: int = 0,
    old_interval: int = 1,
    new_interval: int = 1,
    policy: str = "carry",
) -> tuple[Any, TransitionReport]:
    """Move compressor state across a re-plan boundary.

    Returns ``(new_state, report)``.  ``params_like`` are the current
    parameters in leaf order; a re-initialised state is built over them
    (``new_compressor.init_state(params_like, new_plan)``)."""
    if policy not in ("carry", "rescale", "flush"):
        raise ValueError(f"unknown transition policy {policy!r}")
    norm_before = residual_norm(comp_state)
    fresh = new_compressor.init_state(params_like, new_plan)

    def report(state, eff_policy):
        return state, TransitionReport(
            step=int(step),
            old_interval=int(old_interval),
            new_interval=int(new_interval),
            policy=eff_policy,
            norm_before=norm_before,
            norm_after=residual_norm(state),
        )

    if policy == "flush":
        return report(fresh, "flush")
    if not _same_structure(comp_state, fresh):
        # EF turned on or off, or the state family changed: no meaningful
        # carry exists, so reinit and report the dropped norm
        return report(fresh, "reinit")
    if policy == "rescale" and new_interval < old_interval:
        factor = float(new_interval) / float(max(old_interval, 1))
        return report(_scaled(comp_state, factor), "rescale")
    # "rescale" with a cadence that does not shorten is a plain carry
    return report(comp_state, "carry")


__all__ = ["TransitionReport", "carry_comp_state", "residual_norm"]
