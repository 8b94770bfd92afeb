"""Plain PyTorch versions of the port's kernels: what a wrapper runs for a
CPU tensor, and what ``chip_smoke.py`` holds each CUDA kernel against."""
from __future__ import annotations

import torch


def wire_torch_dtype(wire_dtype) -> torch.dtype | None:
    """``None``/``""`` -> ``None``; a dtype name (``"bfloat16"``) or a
    ``torch.dtype`` -> the ``torch.dtype``."""
    if wire_dtype is None or wire_dtype == "":
        return None
    if isinstance(wire_dtype, torch.dtype):
        return wire_dtype
    dt = getattr(torch, str(wire_dtype), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a dtype name: {wire_dtype!r}")
    return dt


def ef_update_ref(g: torch.Tensor, r: torch.Tensor, coeff: float, *,
                  selected: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``t = g + coeff * r`` in two roundings (product, then sum).

    Selected: ``(send, r') = (t, 0)``; unselected: ``(0, t)``.  The same
    function as ``repro.kernels.ref.ef_update_ref`` run eagerly."""
    t = g + coeff * r
    if selected:
        return t, torch.zeros_like(t)
    return torch.zeros_like(t), t


def pack_ef_cast_ref(g: torch.Tensor, r: torch.Tensor | None, coeff, *,
                     selected: bool, wire_dtype=None):
    """Fused pack + error feedback + wire cast, op for op the function of
    ``repro.kernels.ref.pack_ef_cast_ref`` run eagerly.

    ``t = g + coeff * r`` (two roundings; ``r=None`` gives ``t = g``,
    ``coeff=None`` the plain add).  Selected: the wire value is ``t`` cast
    to ``wire_dtype`` (``t`` itself without a cast) and the residual is the
    cast's error ``t - cast(t)`` (zeros without a cast).  Unselected: the
    wire is zeros and the residual is ``t``.  Returns ``(wire, r_new)``;
    ``r_new`` is ``None`` when ``r`` is."""
    if r is None:
        t = g
    elif coeff is None:
        t = g + r.to(g.dtype)
    else:
        t = g + coeff * r.to(g.dtype)
    wd = wire_torch_dtype(wire_dtype)
    if not selected:
        zero = torch.zeros_like(t, dtype=wd if wd is not None else t.dtype)
        return zero, (t if r is not None else None)
    if wd is None or t.dtype == wd:
        return t, (torch.zeros_like(t) if r is not None else None)
    w = t.to(wd)
    return w, (t - w.to(t.dtype) if r is not None else None)
