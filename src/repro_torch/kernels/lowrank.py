"""PowerSGD's low-rank products: wrapper around the CUDA kernel in
``csrc/lowrank_matmul.cu`` (the port of ``repro.kernels.lowrank.matmul``).

:func:`matmul` computes ``A @ B`` in float32 for ``(B, m, k) @ (B, k, n)``
(or 2-D ``(m, k) @ (k, n)``), FP32 FMA with no tensor cores.  ``trans_a``
and ``trans_b`` take an operand that holds the matrix transposed in its last
two axes and read it through its strides, so ``M^T @ P`` and ``P @ Q'^T``
never materialise a transpose.  For CUDA tensors it launches the kernel (a
split-k product when the output is too small to fill the card, summed in a
fixed order, so the result is the same from run to run) or raises; for CPU
tensors it runs :func:`~repro_torch.kernels.ref.matmul_ref`.  The kernel
sums in another order than cuBLAS, so the two agree to a few ulps of
``|A| @ |B|``, not bitwise.

``matmul.launches`` counts calls that launched the kernel, and only those.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import matmul_ref


@functools.cache
def _launchers():
    lib = _build.load("lowrank_matmul")
    ws = lib.lowrank_matmul_workspace
    ws.argtypes = [ctypes.c_int] * 4
    ws.restype = ctypes.c_longlong
    launch = lib.lowrank_matmul_launch
    launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    launch.restype = ctypes.c_int
    return ws, launch


def _logical(x: torch.Tensor, trans: bool, name: str):
    """``x`` as a batched operand: its shape ``(B, rows, cols)`` and element
    strides of the matrix it stands for (the transpose's when ``trans``)."""
    if x.dtype != torch.float32:
        raise TypeError(f"lowrank.matmul: {name} must be float32, got {x.dtype}")
    if x.dim() not in (2, 3):
        raise ValueError(f"lowrank.matmul: {name} must be 2-D or 3-D, got shape "
                         f"{tuple(x.shape)}")
    x3 = x if x.dim() == 3 else x.unsqueeze(0)
    sb, s1, s2 = x3.stride()
    B, r, c = x3.shape
    if trans:
        return (B, c, r), (sb, s2, s1)
    return (B, r, c), (sb, s1, s2)


def matmul(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
           trans_b: bool = False) -> torch.Tensor:
    """``A @ B``: ``a`` is ``A`` ``(B, m, k)`` (``(B, k, m)`` with
    ``trans_a``), ``b`` is ``B`` ``(B, k, n)`` (``(B, n, k)`` with
    ``trans_b``); both float32 on one device, with any strides.  Returns a
    contiguous float32 ``(B, m, n)``, or ``(m, n)`` when both operands are
    2-D."""
    (Ba, m, k), sa = _logical(a, trans_a, "a")
    (Bb, k2, n), sb = _logical(b, trans_b, "b")
    if a.dim() != b.dim():
        raise ValueError(f"lowrank.matmul: a is {a.dim()}-D, b is {b.dim()}-D")
    if Ba != Bb or k != k2:
        raise ValueError(f"lowrank.matmul: cannot multiply ({Ba}, {m}, {k}) by "
                         f"({Bb}, {k2}, {n})")
    if a.device != b.device:
        raise ValueError(f"lowrank.matmul: a on {a.device}, b on {b.device}")
    if a.device.type != "cuda":
        return matmul_ref(a, b, trans_a=trans_a, trans_b=trans_b)
    if Ba > 65535:
        raise ValueError(f"lowrank.matmul: batch {Ba} above the kernel's 65535")
    out = torch.empty((Ba, m, n), dtype=torch.float32, device=a.device)
    if out.numel() and k == 0:
        out.zero_()
    elif out.numel():
        workspace, launch = _launchers()
        need = workspace(Ba, m, n, k)
        ws = torch.empty(need, dtype=torch.float32, device=a.device) if need else None
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                         ws.data_ptr() if ws is not None else None, need,
                         Ba, m, n, k, *sa, *sb, stream)
        if err != 0:
            raise RuntimeError(f"lowrank.matmul kernel launch failed: cudaError {err}")
        matmul.launches += 1
    return out if a.dim() == 3 else out[0]


matmul.launches = 0
