"""PowerSGD's low-rank products: wrapper around the CUDA kernels in
``csrc/lowrank_matmul.cu`` (the port of ``repro.kernels.lowrank.matmul``).

:func:`matmul` computes ``A @ B`` in float32 for ``(B, m, k) @ (B, k, n)``
(or 2-D ``(m, k) @ (k, n)``), FP32 FMA with no tensor cores.  ``trans_a``
and ``trans_b`` take an operand that holds the matrix transposed in its last
two axes and read it through its strides, so ``M^T @ P`` and ``P @ Q'^T``
never materialise a transpose.  For CUDA tensors it launches a kernel or
raises; for CPU tensors it runs :func:`~repro_torch.kernels.ref.matmul_ref`.

Which kernel is :func:`route`'s choice, from the logical shapes and strides
(see ``ROUTES``): PowerSGD's three products at rank <= 4, with the large
operand M laid out with unit stride along its rows, take one of three
streaming kernels that move M's bytes once as 16-byte accesses; every other
call takes the general tiled kernel.  All of them sum in a fixed order, so
the result is the same from run to run; they sum in another order than
cuBLAS, so the two agree to a few ulps of ``|A| @ |B|``, not bitwise.

``matmul.launches`` counts calls that launched a kernel, and only those;
``matmul.launches_by_route`` splits that count by route.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import matmul_ref


# route -> what it takes (the streamed operand: A for the first two, C for
# the third; its row stride a multiple of 4 and its base 16-byte aligned)
ROUTES = {
    "rowdot": "P = M@Q: n <= 4, A with unit stride along k, k % 4 == 0",
    "colacc": "Q' = M^T@P: n <= 4, A with unit stride along m, m % 4 == 0",
    "outer": "P@Q'^T: k <= 4, n % 4 == 0",
    "tiled": "anything else",
}
_STREAM_ID = {"rowdot": 1, "colacc": 2, "outer": 3}


@functools.cache
def _launchers():
    lib = _build.load("lowrank_matmul")
    strides = [ctypes.c_longlong] * 6
    ws = lib.lowrank_matmul_workspace
    ws.argtypes = [ctypes.c_int] * 4
    ws.restype = ctypes.c_longlong
    launch = lib.lowrank_matmul_launch
    launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                       + strides + [ctypes.c_void_p])
    launch.restype = ctypes.c_int
    stream_ws = lib.lowrank_stream_workspace
    stream_ws.argtypes = [ctypes.c_int] * 5
    stream_ws.restype = ctypes.c_longlong
    stream_launch = lib.lowrank_stream_launch
    stream_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                              + [ctypes.c_int] * 4 + strides + [ctypes.c_void_p])
    stream_launch.restype = ctypes.c_int
    return {"tiled": (ws, launch), "stream": (stream_ws, stream_launch)}


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


def _operands(a: torch.Tensor, b: torch.Tensor, trans_a: bool, trans_b: bool):
    """Check the operands; -> ``(B, m, n, k, a's strides, b's strides)`` of
    the logical product."""
    (Ba, m, k), sa = _logical(a, trans_a, "a")
    (Bb, k2, n), sb = _logical(b, trans_b, "b")
    if a.dim() != b.dim():
        raise ValueError(f"lowrank.matmul: a is {a.dim()}-D, b is {b.dim()}-D")
    if Ba != Bb or k != k2:
        raise ValueError(f"lowrank.matmul: cannot multiply ({Ba}, {m}, {k}) by "
                         f"({Bb}, {k2}, {n})")
    if a.device != b.device:
        raise ValueError(f"lowrank.matmul: a on {a.device}, b on {b.device}")
    return Ba, m, n, k, sa, sb


def _route(m: int, n: int, k: int, sa, a_ptr: int) -> str:
    sab, sai, sak = sa
    streamable = a_ptr % 16 == 0 and sab % 4 == 0
    if n <= 4 and sak == 1 and k % 4 == 0 and sai % 4 == 0 and streamable:
        return "rowdot"
    if n <= 4 and sai == 1 and m % 4 == 0 and sak % 4 == 0 and streamable:
        return "colacc"
    if k <= 4 and n % 4 == 0:            # C is contiguous and 16-byte aligned
        return "outer"
    return "tiled"


def route(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
          trans_b: bool = False) -> str:
    """The kernel :func:`matmul` launches for these operands on the card: a
    key of ``ROUTES``.  Works on tensors of any device, ``meta`` included."""
    _, m, n, k, sa, _ = _operands(a, b, trans_a, trans_b)
    return _route(m, n, k, sa, a.data_ptr())


def matmul(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
           trans_b: bool = False) -> torch.Tensor:
    """``A @ B``: ``a`` is ``A`` ``(B, m, k)`` (``(B, k, m)`` with
    ``trans_a``), ``b`` is ``B`` ``(B, k, n)`` (``(B, n, k)`` with
    ``trans_b``); both float32 on one device, with any strides.  Returns a
    contiguous float32 ``(B, m, n)``, or ``(m, n)`` when both operands are
    2-D."""
    Ba, m, n, k, sa, sb = _operands(a, b, trans_a, trans_b)
    if a.device.type != "cuda":
        return matmul_ref(a, b, trans_a=trans_a, trans_b=trans_b)
    if Ba > 65535:
        raise ValueError(f"lowrank.matmul: batch {Ba} above the kernel's 65535")
    out = torch.empty((Ba, m, n), dtype=torch.float32, device=a.device)
    if out.numel() and k == 0:
        out.zero_()
    elif out.numel():
        which = _route(m, n, k, sa, a.data_ptr())
        kernels = _launchers()
        if which == "tiled":
            workspace, launch = kernels["tiled"]
            need = workspace(Ba, m, n, k)
            args = ()
        else:
            workspace, launch = kernels["stream"]
            need = workspace(_STREAM_ID[which], Ba, m, n, k)
            args = (_STREAM_ID[which],)
        ws = torch.empty(need, dtype=torch.float32, device=a.device) if need else None
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = launch(*args, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                         ws.data_ptr() if ws is not None else None, need,
                         Ba, m, n, k, *sa, *sb, stream)
        if err != 0:
            raise RuntimeError(f"lowrank.matmul {which} kernel launch failed: "
                               f"cudaError {err}")
        matmul.launches += 1
        matmul.launches_by_route[which] += 1
    return out if a.dim() == 3 else out[0]


matmul.launches = 0
matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
