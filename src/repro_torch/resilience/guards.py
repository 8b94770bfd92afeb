"""Cheap numeric guardrails over the training step (the counterpart of
``repro.resilience.guards``).

Every check is (a) a scalar the step already computes (``total_loss`` and
``grad_norm``: a NaN or Inf anywhere in the gradient reaches the global
norm, so one finite check on it has the detection power of a per-leaf
sweep), (b) one reduction per packed arena plane
(:func:`plane_nonfinite_counts`), or (c) a cadenced O(params) reduction,
the EF-residual watchdog: one fused norm over the residual tensors every
``residual_check_every`` steps.

Three guards:

* **nonfinite**: the loss or the global gradient norm is NaN or Inf.
* **loss_spike**: the loss exceeds ``loss_spike_factor`` times the rolling
  median of the last ``loss_window`` clean losses (armed after
  ``loss_spike_min_steps`` of them).
* **residual**: the EF residual norm exceeds ``residual_abs_max``.  The
  residual is deferred gradient (COVAP's improved error feedback keeps the
  unsent mass there), so a diverging residual poisons every later flush
  long before the loss moves; this guard enters the ladder at the
  EF-flush rung.

What these guards cannot see: drift that stays finite and small (a
low-mantissa bit flip looks like rounding), corruption in the optimizer
moments, and a corrupted element that no batch reads (an embedding row of
a token the batches do not hold gives no gradient).  The checkpoint
store's digest covers corruption at rest.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from .faults import tree_leaves

GUARD_KINDS = ("nonfinite", "loss_spike", "residual")


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Knobs for the guard battery and (read by ``recovery.py``) the
    escalation ladder's bounds."""

    check_every: int = 1            # host-side metric check cadence (steps)
    # the deferred checks are read in batches of this many steps: one
    # blocking device-to-host read per batch; every step is still checked,
    # detection waits up to check_every * sync_every steps.  1 = the strict
    # lag-one pipeline.
    sync_every: int = 4
    loss_window: int = 32           # rolling-median window for spikes
    loss_spike_factor: float = 100.0
    loss_spike_min_steps: int = 8   # clean samples before the spike guard arms
    residual_check_every: int = 8   # EF-norm watchdog cadence (0 = off)
    residual_abs_max: float = 1e12
    # --- escalation ladder bounds (recovery.py) ---
    max_skips: int = 2              # skip-step rungs per incident
    max_flushes: int = 1            # EF-flush rungs per incident
    max_rewinds: int = 2            # checkpoint rewinds per RUN (never reset)
    retry_backoff_s: float = 0.0    # sleep between escalations
    # --- guard-owned checkpointing (the rewind target) ---
    ckpt_dir: str | None = None
    ckpt_every: int = 0             # 0 = never save; rewind needs a dir and a cadence

    def __post_init__(self):
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")
        if self.sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if self.loss_window < 2:
            raise ValueError("loss_window must be >= 2")


def as_guard_config(obj) -> GuardConfig | None:
    """Coerce the ``guards=`` argument: None and False pass as None, True
    means the defaults, a dict is keyword overrides."""
    if obj is None or isinstance(obj, GuardConfig):
        return obj
    if obj is True:
        return GuardConfig()
    if obj is False:
        return None
    if isinstance(obj, dict):
        return GuardConfig(**obj)
    raise TypeError(
        f"guards must be None/True/False, a GuardConfig or a dict of overrides; "
        f"got {type(obj).__name__}")


@dataclasses.dataclass(frozen=True)
class GuardTrip:
    """One guard firing: the observed statistic and the limit it crossed
    (a NaN value for non-finite trips)."""

    step: int
    guard: str
    reason: str
    value: float = float("nan")
    threshold: float = float("nan")


@torch.no_grad()
def plane_nonfinite_counts(planes: Sequence[torch.Tensor]) -> list[int]:
    """Non-finite element count per packed arena plane: one
    ``sum(~isfinite)`` reduction per plane and one host transfer for all
    of them."""
    if not planes:
        return []
    counts = torch.stack([(~torch.isfinite(p)).sum() for p in planes])
    return [int(c) for c in counts.tolist()]


def residual_leaves(comp_state: Any) -> list[torch.Tensor]:
    """The floating residual tensors of a compressor state: PowerSGD's
    ``residual`` half (not its Q), or every floating leaf."""
    if isinstance(comp_state, dict) and "residual" in comp_state:
        comp_state = comp_state["residual"]
    return [x for x in tree_leaves(comp_state)
            if isinstance(x, torch.Tensor) and x.is_floating_point()]


@torch.no_grad()
def residual_norm_async(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The residuals' global L2 norm in float32 as a 0-dim device tensor,
    with no host synchronisation: one fused per-tensor norm
    (``torch._foreach_norm``) and the norm of those norms."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(list(leaves), 2, dtype=torch.float32)))


class Guards:
    """The guard battery.  ``check(step, metrics, comp_state)`` runs on the
    resilience runtime's host cadence with the step's host-side scalar
    metrics and returns the trips (empty on a clean step).  It keeps state
    only in the rolling loss window."""

    def __init__(self, config: GuardConfig | None = None):
        self.config = config or GuardConfig()
        self._losses: list[float] = []
        self.trips: list[GuardTrip] = []

    # -- individual guards --------------------------------------------------
    def _check_nonfinite(self, step: int, loss: float,
                         gnorm: float | None) -> GuardTrip | None:
        if not math.isfinite(loss):
            return GuardTrip(step, "nonfinite", f"loss={loss}", value=loss)
        if gnorm is not None and not math.isfinite(gnorm):
            return GuardTrip(step, "nonfinite", f"grad_norm={gnorm}", value=gnorm)
        return None

    def _check_loss_spike(self, step: int, loss: float) -> GuardTrip | None:
        cfg = self.config
        window = self._losses[-cfg.loss_window:]
        if len(window) >= cfg.loss_spike_min_steps:
            med = float(np.median(window))
            limit = cfg.loss_spike_factor * max(abs(med), 1e-8)
            if abs(loss) > limit:
                return GuardTrip(step, "loss_spike",
                                 f"|loss|={abs(loss):.3e} > {cfg.loss_spike_factor:g}x "
                                 f"median {med:.3e}", value=loss, threshold=limit)
        return None

    def _check_residual(self, step: int, comp_state: Any,
                        value: float | None = None) -> GuardTrip | None:
        """``value`` is a norm from :meth:`residual_async` (the caller
        applied the cadence); without it the cadence is applied here and
        the norm read synchronously."""
        cfg = self.config
        if value is None:
            if cfg.residual_check_every <= 0 or comp_state is None:
                return None
            if step % cfg.residual_check_every != 0:
                return None
            leaves = residual_leaves(comp_state)
            if not leaves:
                return None
            value = float(residual_norm_async(leaves))
        if not math.isfinite(value) or value > cfg.residual_abs_max:
            return GuardTrip(step, "residual",
                             f"EF residual norm {value:.3e} exceeds "
                             f"{cfg.residual_abs_max:.1e}",
                             value=value, threshold=cfg.residual_abs_max)
        return None

    def residual_async(self, step: int, comp_state: Any) -> torch.Tensor | None:
        """Launch the residual-norm reduction without reading it: a 0-dim
        device tensor, or None when the cadence or the state says no check
        is due.  The runtime calls this when it enqueues a step, so the
        batched read finds the norm computed."""
        cfg = self.config
        if cfg.residual_check_every <= 0 or comp_state is None:
            return None
        if step % cfg.residual_check_every != 0:
            return None
        leaves = residual_leaves(comp_state)
        return residual_norm_async(leaves) if leaves else None

    # -- the battery --------------------------------------------------------
    def check(self, step: int, metrics: dict, comp_state: Any = None,
              residual_value: float | None = None) -> list[GuardTrip]:
        """Run every guard against one step's host-side metrics.  The loss
        window learns from clean steps only: a tripped step's loss must not
        drag the median toward the blow-up."""
        loss = float(metrics.get("loss", metrics.get("total_loss", 0.0)))
        gnorm = metrics.get("grad_norm")
        gnorm = None if gnorm is None else float(gnorm)
        trips = []
        t = self._check_nonfinite(step, loss, gnorm)
        if t is None:
            t = self._check_loss_spike(step, loss)
        if t is not None:
            trips.append(t)
        rt = self._check_residual(step, comp_state, value=residual_value)
        if rt is not None:
            trips.append(rt)
        if not trips:
            self._losses.append(loss)
            if len(self._losses) > 4 * self.config.loss_window:
                del self._losses[: -2 * self.config.loss_window]
        self.trips.extend(trips)
        return trips

    def reset_window(self) -> None:
        """Drop the loss history (after a checkpoint rewind, where the old
        window no longer describes the trajectory)."""
        self._losses.clear()


__all__ = [
    "GUARD_KINDS",
    "GuardConfig",
    "GuardTrip",
    "Guards",
    "as_guard_config",
    "plane_nonfinite_counts",
    "residual_leaves",
    "residual_norm_async",
]
