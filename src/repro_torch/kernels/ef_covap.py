"""COVAP error-feedback update: wrapper around the CUDA kernel in
``csrc/ef_covap.cu`` (the port of ``repro.kernels.ef_covap.ef_update``).

One pass over a flat f32 segment computes ``t = g + c*r`` and splits it
into ``(send, r')``: ``(t, 0)`` for a selected bucket, ``(0, t)`` for an
unselected one.  For CUDA tensors :func:`ef_update` launches the kernel or
raises; for CPU tensors it runs :func:`~repro_torch.kernels.ref.ef_update_ref`.
The kernel rounds ``g + c*r`` exactly as the plain version does (no FMA
contraction), so on the card the two agree bit for bit.

``ef_update.launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import ef_update_ref


def _check(g: torch.Tensor, r: torch.Tensor) -> None:
    for name, x in (("g", g), ("r", r)):
        if x.dtype != torch.float32:
            raise TypeError(f"ef_update: {name} must be float32, got {x.dtype}")
        if x.dim() != 1:
            raise ValueError(
                f"ef_update: {name} must be a flat (N,) vector, got shape "
                f"{tuple(x.shape)}"
            )
        if not x.is_contiguous():
            raise ValueError(f"ef_update: {name} must be contiguous")
    if g.shape != r.shape:
        raise ValueError(
            f"ef_update: g {tuple(g.shape)} and r {tuple(r.shape)} differ in shape"
        )
    if g.device != r.device:
        raise ValueError(f"ef_update: g on {g.device}, r on {r.device}")


@functools.cache
def _launcher():
    fn = _build.load("ef_covap").ef_update_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def ef_update_cuda(g: torch.Tensor, r: torch.Tensor, coeff: float, *,
                   selected: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel.  Raises for anything it does not take,
    CPU tensors included."""
    _check(g, r)
    if g.device.type != "cuda":
        raise ValueError(
            f"ef_update_cuda needs CUDA tensors, got tensors on {g.device}"
        )
    send = torch.empty_like(g)
    rnew = torch.empty_like(g)
    n = g.numel()
    if n == 0:
        return send, rnew
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = _launcher()(
            g.data_ptr(), r.data_ptr(), float(coeff),
            send.data_ptr(), rnew.data_ptr(), n, int(bool(selected)), stream,
        )
    if err != 0:
        raise RuntimeError(f"ef_update kernel launch failed: cudaError {err}")
    ef_update.launches += 1
    return send, rnew


def ef_update(g: torch.Tensor, r: torch.Tensor, coeff: float, *,
              selected: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``g``, ``r``: flat ``(N,)`` float32 segment on one device; ``coeff``
    a Python float.  Returns ``(send, r_new)``."""
    if g.device.type == "cuda":
        return ef_update_cuda(g, r, coeff, selected=selected)
    _check(g, r)
    return ef_update_ref(g, r, coeff, selected=selected)


ef_update.launches = 0
