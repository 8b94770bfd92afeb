"""Block-scaled FP8 quantize and dequantize: wrappers around the CUDA kernels
in ``csrc/quantize_fp8.cu`` (the port of ``repro.kernels.quantize``).

:func:`quantize_fp8` cuts a flat float32 vector into blocks of ``block``
elements from element 0 and returns ``(q, scales)``: ``q`` in
``float8_e4m3fn`` and one float32 scale per block,
``max(amax / 448, 1e-12)``.  :func:`dequantize_fp8` returns
``float32(q) * scale``.  For CUDA tensors each launches its kernel or
raises; for CPU tensors it runs
:func:`~repro_torch.kernels.ref.quantize_fp8_ref` or
:func:`~repro_torch.kernels.ref.dequantize_fp8_ref`.  The kernels divide and
round as the plain versions do, so on the card the two agree bit for bit.

Both take output views (``q_out``/``scales_out``, ``out``) where the caller
has them.  ``quantize_fp8.launches`` and ``dequantize_fp8.launches`` count
kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import FP8_BLOCK, dequantize_fp8_ref, quantize_fp8_ref


def num_blocks(n: int, block: int) -> int:
    return -(-int(n) // int(block))


def _check_flat(fn: str, name: str, x: torch.Tensor, dtype: torch.dtype,
                numel: int | None = None, device=None) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {x.dtype}")
    if x.dim() != 1:
        raise ValueError(f"{fn}: {name} must be a flat (N,) vector, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
    if numel is not None and x.numel() != numel:
        raise ValueError(f"{fn}: {name} has {x.numel()} elements, needs {numel}")
    if device is not None and x.device != device:
        raise ValueError(f"{fn}: {name} on {x.device}, the input on {device}")


def _check_block(fn: str, block: int) -> int:
    if int(block) != block or block <= 0:
        raise ValueError(f"{fn}: block must be a positive integer, got {block!r}")
    return int(block)


@functools.cache
def _launchers():
    lib = _build.load("quantize_fp8")
    quant = lib.quantize_fp8_launch
    quant.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    quant.restype = ctypes.c_int
    dequant = lib.dequantize_fp8_launch
    dequant.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    dequant.restype = ctypes.c_int
    return quant, dequant


def quantize_fp8(x: torch.Tensor, block: int = FP8_BLOCK, *,
                 q_out: torch.Tensor | None = None,
                 scales_out: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x``: flat ``(N,)`` float32.  Returns ``(q, scales)``, written into
    ``q_out`` (``(N,)`` float8_e4m3fn) and ``scales_out`` (``(nb,)``
    float32) when given."""
    fn = "quantize_fp8"
    block = _check_block(fn, block)
    _check_flat(fn, "x", x, torch.float32)
    n, nb = x.numel(), num_blocks(x.numel(), block)
    for name, out, dt, k in (("q_out", q_out, torch.float8_e4m3fn, n),
                             ("scales_out", scales_out, torch.float32, nb)):
        if out is not None:
            _check_flat(fn, name, out, dt, k, x.device)
    q = q_out if q_out is not None else torch.empty(
        n, dtype=torch.float8_e4m3fn, device=x.device)
    scales = scales_out if scales_out is not None else torch.empty(
        nb, dtype=torch.float32, device=x.device)
    if x.device.type != "cuda":
        pq, ps = quantize_fp8_ref(x, block)
        q.copy_(pq)
        scales.copy_(ps)
        return q, scales
    if n == 0:
        return q, scales
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launchers()[0](x.data_ptr(), q.data_ptr(), scales.data_ptr(),
                              n, block, stream)
    if err != 0:
        raise RuntimeError(f"quantize_fp8 kernel launch failed: cudaError {err}")
    quantize_fp8.launches += 1
    return q, scales


def dequantize_fp8(q: torch.Tensor, scales: torch.Tensor,
                   block: int = FP8_BLOCK, *,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """``q``: flat ``(N,)`` float8_e4m3fn; ``scales``: ``(nb,)`` float32.
    Returns ``float32(q) * scales[i // block]``, written into ``out``
    (``(N,)`` float32) when given."""
    fn = "dequantize_fp8"
    block = _check_block(fn, block)
    _check_flat(fn, "q", q, torch.float8_e4m3fn)
    n = q.numel()
    _check_flat(fn, "scales", scales, torch.float32, num_blocks(n, block), q.device)
    if out is not None:
        _check_flat(fn, "out", out, torch.float32, n, q.device)
    else:
        out = torch.empty(n, dtype=torch.float32, device=q.device)
    if q.device.type != "cuda":
        out.copy_(dequantize_fp8_ref(q, scales, block))
        return out
    if n == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launchers()[1](q.data_ptr(), scales.data_ptr(), out.data_ptr(),
                              n, block, stream)
    if err != 0:
        raise RuntimeError(f"dequantize_fp8 kernel launch failed: cudaError {err}")
    dequantize_fp8.launches += 1
    return out


quantize_fp8.launches = 0
dequantize_fp8.launches = 0
