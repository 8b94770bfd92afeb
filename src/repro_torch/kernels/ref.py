"""Plain PyTorch versions of the port's kernels: what a wrapper runs for a
CPU tensor, and what ``chip_smoke.py`` holds each CUDA kernel against."""
from __future__ import annotations

import torch


def ef_update_ref(g: torch.Tensor, r: torch.Tensor, coeff: float, *,
                  selected: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``t = g + coeff * r`` in two roundings (product, then sum).

    Selected: ``(send, r') = (t, 0)``; unselected: ``(0, t)``.  The same
    function as ``repro.kernels.ref.ef_update_ref`` run eagerly."""
    t = g + coeff * r
    if selected:
        return t, torch.zeros_like(t)
    return torch.zeros_like(t), t
