"""Gradient clipping by global norm."""
from __future__ import annotations

import torch


@torch.no_grad()
def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


@torch.no_grad()
def clip_by_global_norm(tensors: list[torch.Tensor], max_norm: float):
    """-> (clipped tensors, the norm before clipping)."""
    norm = global_norm(tensors)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return [(t * scale).to(t.dtype) for t in tensors], norm
