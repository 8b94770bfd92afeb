"""Causal attention on the card: wrapper around the CUDA kernels in
``csrc/causal_attn.cu`` (one fused forward, a backward without atomics),
behind a ``torch.autograd.Function`` (:func:`causal_attn`).

It replaces no TPU kernel: the reference leaves attention to XLA, and its
Pallas kernels are all in the sync path.  It was added because the plain
path (``models.attention._attend_plain``: for every 256-query chunk the
scores over every key, an f32 softmax, a mask applied afterwards) moves
the whole score tensor through device memory several times, in the
forward, the remat recompute and the backward, and computes twice the
causal products.  The kernels keep the scores on chip and skip the blocks
past the diagonal; the source's header gives the design.

Inputs are read as ``_attend`` holds them, through their strides: q
``(B,S,K,G,hq)``, k ``(B,S,K,hq)``, v ``(B,S,K,hv)``, the last dimension
unit-strided; gradients come back in the same shapes.  bf16 and fp16
multiply on the tensor cores with f32 sums, at the head widths padded up
to the first pair of :data:`WIDTHS` that holds them (192/128 is a pair of
its own, so latent attention's scores are not padded to 256); float32
multiplies in full float32 (no TF32) at any width up to 256.  The softcap
``cap·tanh(s/cap)`` applies to the scaled f32 scores before the mask, its
derivative in the backward.

``causal_attn.launches`` counts kernel launches, and only those: one for a
forward, three for a backward.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MAX_HEAD = 256
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the (q/k, v) widths the tensor-core kernels are instantiated at, in the
# order they are tried; csrc/causal_attn.cu CAUSAL_ATTN_WIDTHS lists the same
WIDTHS = ((32, 32), (64, 64), (128, 128), (192, 128), (256, 256))


def widths(dtype: torch.dtype, hq: int, hv: int) -> tuple[int, int]:
    """The kernels' padded (q/k, v) widths for inputs of ``dtype`` with head
    widths ``hq`` and ``hv``: the first pair of :data:`WIDTHS` that holds
    both for bf16 and fp16, the widths themselves for float32.  Raises for
    another dtype or a width outside 1..256."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"causal_attn: inputs must be float32, bfloat16 or float16, "
                        f"got {dtype}")
    for name, h in (("q/k", hq), ("v", hv)):
        if not 1 <= h <= MAX_HEAD:
            raise ValueError(f"causal_attn: {name} head width {h} is outside 1..{MAX_HEAD}")
    if dtype == torch.float32:
        return hq, hv
    return next((dq, dv) for dq, dv in WIDTHS if hq <= dq and hv <= dv)


def _check(q, k, v, window: int, softcap: float) -> None:
    """Raises for arguments the kernels do not take; the device last, so
    that each other refusal shows on CPU tensors too."""
    for name, x, dims in (("q", q, 5), ("k", k, 4), ("v", v, 4)):
        if not isinstance(x, torch.Tensor) or x.dim() != dims:
            raise ValueError(f"causal_attn: {name} must be a {dims}-dim tensor, got "
                             f"{getattr(x, 'shape', type(x))}")
        if x.dtype != q.dtype:
            raise TypeError(f"causal_attn: {name} is {x.dtype}, q is {q.dtype}")
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"causal_attn: {name}'s last dimension must be unit-strided, "
                             f"got strides {x.stride()}")
    B, S, K, _, hq = q.shape
    if tuple(k.shape) != (B, S, K, hq):
        raise ValueError(f"causal_attn: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}: want {(B, S, K, hq)}")
    if tuple(v.shape[:3]) != (B, S, K):
        raise ValueError(f"causal_attn: v {tuple(v.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if 0 in q.shape[:4]:
        raise ValueError(f"causal_attn: empty q {tuple(q.shape)}")
    if window < 0 or softcap < 0:
        raise ValueError(f"causal_attn: window {window} and softcap {softcap} must be "
                         f">= 0")
    widths(q.dtype, hq, v.shape[-1])
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"causal_attn: needs CUDA tensors on one card, got {name} "
                             f"on {x.device}, q on {q.device}")


def _words(*xs: torch.Tensor) -> int:
    """1 when the tensor-core kernels may copy every row of ``xs`` as
    16-byte words: 2-byte elements, 16-byte aligned, every stride and the
    width a multiple of 8 elements."""
    return int(all(x.element_size() == 2 and x.data_ptr() % 16 == 0
                   and all(s % 8 == 0 for s in x.stride()[:-1]) and x.shape[-1] % 8 == 0
                   for x in xs))


@functools.cache
def _launchers():
    lib = _build.load("causal_attn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = lib.causal_attn_fwd_launch
    fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, i, i, p]
    bwd = lib.causal_attn_bwd_launch
    bwd.argtypes = [p] * 11 + [i] * 9 + [f, f, i, i, p]
    for fn in (fwd, bwd):
        fn.restype = ctypes.c_int
    return fwd, bwd


def _strides(*xs: torch.Tensor | None) -> ctypes.Array:
    """The launchers' 28 strides: (batch, position, head[, group]) of q, k,
    v, o, dO, dq, dk, dv (zeros for a tensor the launch does not read)."""
    dims = (4, 3, 3, 4, 4, 4, 3, 3)
    out = []
    for x, n in zip(xs + (None,) * (len(dims) - len(xs)), dims):
        out += list(x.stride()[:n]) if x is not None else [0] * n
    return (ctypes.c_longlong * len(out))(*out)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"causal_attn {what} launch failed: cudaError {err}")


def _forward(q, k, v, window: int, softcap: float):
    B, S, NK, G, hq = q.shape
    hv = v.shape[-1]
    dq, dv = widths(q.dtype, hq, hv)
    o = torch.empty((B, S, NK, G, hv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, NK, G, S), dtype=torch.float32, device=q.device)
    fwd, _ = _launchers()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  _strides(q, k, v, o), B, S, NK, G, hq, hv, dq, dv, window, hq ** -0.5,
                  softcap, DTYPE_CODES[q.dtype], _words(q, k, v), stream)
    _raise_on(err, "forward")
    causal_attn.launches += 1
    return o, lse


def _backward(q, k, v, o, lse, do, window: int, softcap: float):
    B, S, NK, G, hq = q.shape
    hv = v.shape[-1]
    if do.shape[-1] > 1 and do.stride(-1) != 1:
        do = do.contiguous()
    dqw, dvw = widths(q.dtype, hq, hv)
    dl = torch.empty_like(lse)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _, bwd = _launchers()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), dl.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), _strides(q, k, v, o, do, dq, dk, dv), B, S, NK, G, hq, hv,
                  dqw, dvw, window, hq ** -0.5, softcap, DTYPE_CODES[q.dtype],
                  _words(q, k, v, do), stream)
    _raise_on(err, "backward")
    causal_attn.launches += 3
    return dq, dk, dv


class _CausalAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window: int, softcap: float):
        o, lse = _forward(q, k, v, window, softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.softcap = window, softcap
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do, ctx.window, ctx.softcap)
        return dq, dk, dv, None, None


def causal_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Causal attention of q ``(B,S,K,G,hq)`` over k ``(B,S,K,hq)`` and v
    ``(B,S,K,hv)`` -> ``(B,S,K,G,hv)`` in q's dtype, scores at ``hq **
    -0.5``; ``window > 0`` keeps keys ``t`` in ``(q - window, q]``;
    ``softcap > 0`` caps the scaled scores at ``softcap·tanh(s/softcap)``.
    Differentiable in q, k and v.  CUDA tensors of one dtype (float32,
    bfloat16, float16), last dimensions unit-strided, head widths 1..256;
    raises for anything else, CPU tensors included.  Launches on the
    current stream and does not synchronise."""
    window, softcap = int(window), float(softcap)
    _check(q, k, v, window, softcap)
    return _CausalAttn.apply(q, k, v, window, softcap)


causal_attn.launches = 0
