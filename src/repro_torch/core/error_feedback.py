"""Error feedback with COVAP's compensation-coefficient scheduler (SS III.D).

    t         = g + coeff(step) * residual      # compensation
    g'        = filter(t)                       # communicated part
    residual' = t - g'                          # kept locally

    coeff(step) = min(init + floor(step / ascend_steps) * ascend_range, 1)

``step`` is the global step.  The coefficient is computed on the host in
float32, as the reference computes it, and handed to the EF kernel by
value.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EFSchedule:
    init_value: float = 0.3
    ascend_steps: int = 200
    ascend_range: float = 0.1

    def coefficient(self, step: int) -> float:
        """The float32 coefficient of ``step``, returned as a Python float
        (exactly representable in float32)."""
        s = np.float32(step)
        c = np.float32(self.init_value) + np.floor(
            s / np.float32(self.ascend_steps)
        ) * np.float32(self.ascend_range)
        return float(np.minimum(c, np.float32(1.0)))


def init_residual(params: list[torch.Tensor]) -> list[torch.Tensor]:
    return [torch.zeros_like(p) for p in params]


def compensate(grads: list[torch.Tensor], residual: list[torch.Tensor],
               coeff: float) -> list[torch.Tensor]:
    """``t = g + coeff * r`` per leaf (line 2 of Algorithm 1), two roundings
    as the reference's eager form."""
    return [g + coeff * r.to(g.dtype) for g, r in zip(grads, residual)]


def residual_update(t: list[torch.Tensor], sent: list[torch.Tensor]
                    ) -> list[torch.Tensor]:
    """``residual' = t - g'`` per leaf (line 4 of Algorithm 1); ``sent`` is
    the local pre-reduction contribution where it was communicated and zero
    elsewhere."""
    return [a - b for a, b in zip(t, sent)]
