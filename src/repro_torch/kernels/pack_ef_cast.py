"""Fused arena pack + error feedback + wire cast: wrapper around the CUDA
kernel in ``csrc/pack_ef_cast.cu`` (the port of
``repro.kernels.pack_ef_cast.pack_ef_cast``).

One pass over a flat f32 segment computes ``t = g + c*r``, the wire value
and the new residual:

    selected:    wire = cast(t),  r' = t - cast(t)   (0 without a cast)
    unselected:  no wire value,   r' = t

:func:`pack_ef_cast_into` writes into caller-given outputs: ``wire_out``
is the segment's range in its arena slot (its dtype is the wire dtype),
``r_out`` the new residual.  For CUDA tensors it launches the kernel or
raises; for CPU tensors it runs
:func:`~repro_torch.kernels.ref.pack_ef_cast_ref` and copies.
:func:`pack_ef_cast` is the reference's function, which allocates its
outputs and returns zeros as the wire of an unselected segment.  The kernel
rounds as the plain version does (no FMA contraction; round-to-nearest-even
casts), so on the card the two agree bit for bit.

``pack_ef_cast.launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import pack_ef_cast_ref, wire_torch_dtype

_WIRE_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_flat(name: str, x: torch.Tensor, like: torch.Tensor, dtypes) -> None:
    if x.dtype not in dtypes:
        raise TypeError(
            f"pack_ef_cast: {name} must be {' or '.join(map(str, dtypes))}, "
            f"got {x.dtype}"
        )
    if x.dim() != 1:
        raise ValueError(
            f"pack_ef_cast: {name} must be a flat (N,) vector, got shape "
            f"{tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"pack_ef_cast: {name} must be contiguous")
    if x.shape != like.shape:
        raise ValueError(
            f"pack_ef_cast: {name} {tuple(x.shape)} and g {tuple(like.shape)} "
            "differ in shape"
        )
    if x.device != like.device:
        raise ValueError(f"pack_ef_cast: g on {like.device}, {name} on {x.device}")


def _check(g, r, wire_out, r_out, selected) -> None:
    _check_flat("g", g, g, (torch.float32,))
    _check_flat("r", r, g, (torch.float32,))
    _check_flat("r_out", r_out, g, (torch.float32,))
    if wire_out is not None:
        _check_flat("wire_out", wire_out, g, tuple(_WIRE_KIND))
    elif selected:
        raise ValueError("pack_ef_cast: a selected segment needs wire_out")


@functools.cache
def _launcher():
    fn = _build.load("pack_ef_cast").pack_ef_cast_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def pack_ef_cast_into(g: torch.Tensor, r: torch.Tensor, coeff: float,
                      wire_out: torch.Tensor | None, r_out: torch.Tensor, *,
                      selected: bool) -> None:
    """``g``, ``r``, ``r_out``: flat ``(N,)`` float32 on one device;
    ``wire_out``: flat ``(N,)`` float32, bfloat16 or float16, needed for a
    selected segment and left untouched for an unselected one; ``coeff`` a
    Python float.  Writes the wire values and the new residual."""
    _check(g, r, wire_out, r_out, selected)
    if g.device.type != "cuda":
        wire, rnew = pack_ef_cast_ref(
            g, r, coeff, selected=selected,
            wire_dtype=wire_out.dtype if wire_out is not None else None,
        )
        if selected:
            wire_out.copy_(wire)
        r_out.copy_(rnew)
        return
    n = g.numel()
    if n == 0:
        return
    kind = _WIRE_KIND[wire_out.dtype] if wire_out is not None else 0
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = _launcher()(
            g.data_ptr(), r.data_ptr(), float(coeff),
            wire_out.data_ptr() if selected else None, r_out.data_ptr(), n,
            int(bool(selected)), kind, stream,
        )
    if err != 0:
        raise RuntimeError(f"pack_ef_cast kernel launch failed: cudaError {err}")
    pack_ef_cast.launches += 1


def pack_ef_cast(g: torch.Tensor, r: torch.Tensor, coeff: float, *,
                 selected: bool, wire_dtype=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's function: returns ``(wire, r_new)`` with ``wire`` at
    ``wire_dtype`` (``g``'s dtype when ``None``), zeros for an unselected
    segment."""
    wd = wire_torch_dtype(wire_dtype) or g.dtype
    if wd not in _WIRE_KIND:
        raise TypeError(f"pack_ef_cast: no wire type {wd}")
    rnew = torch.empty_like(g)
    wire = (torch.empty if selected else torch.zeros)(
        g.shape, dtype=wd, device=g.device
    )
    pack_ef_cast_into(g, r, coeff, wire if selected else None, rnew,
                      selected=selected)
    return wire, rnew


pack_ef_cast.launches = 0
