"""EFsignSGD sign compression: wrapper around the CUDA kernel in
``csrc/sign_compress.cu`` (the port of ``repro.kernels.sign_compress``).

One pass over a flat float32 vector writes the int8 signs (``+1`` where
``x >= 0``, ``-1`` elsewhere) and one float32 ``sum(|x|)`` per ``block``
elements; :func:`sign_compress` finishes ``scale = sum(partials) / N`` with
one torch reduction on the same device, as the reference finishes it
outside its kernel.  For CUDA tensors :func:`sign_compress_partials`
launches the kernel or raises; for CPU tensors it runs
:func:`~repro_torch.kernels.ref.sign_compress_partials_ref`.  The signs
agree with the plain version bit for bit; the partials sum in another
order, so they and the scale agree to a few ulps.

``sign_compress.launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .quantize import _check_block, _check_flat, num_blocks
from .ref import SIGN_BLOCK, sign_compress_partials_ref


@functools.cache
def _launcher():
    fn = _build.load("sign_compress").sign_compress_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sign_compress_partials(x: torch.Tensor, block: int = SIGN_BLOCK, *,
                           signs_out: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x``: flat ``(N,)`` float32.  Returns ``(signs int8 (N,), partials
    float32 (nb,))``; the signs go into ``signs_out`` when given."""
    fn = "sign_compress"
    block = _check_block(fn, block)
    _check_flat(fn, "x", x, torch.float32)
    n = x.numel()
    if signs_out is not None:
        _check_flat(fn, "signs_out", signs_out, torch.int8, n, x.device)
    signs = signs_out if signs_out is not None else torch.empty(
        n, dtype=torch.int8, device=x.device)
    partials = torch.empty(num_blocks(n, block), dtype=torch.float32,
                           device=x.device)
    if x.device.type != "cuda":
        ps, pp = sign_compress_partials_ref(x, block)
        signs.copy_(ps)
        partials.copy_(pp)
        return signs, partials
    if n == 0:
        return signs, partials
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(x.data_ptr(), signs.data_ptr(), partials.data_ptr(),
                          n, block, stream)
    if err != 0:
        raise RuntimeError(f"sign_compress kernel launch failed: cudaError {err}")
    sign_compress.launches += 1
    return signs, partials


def sign_compress(x: torch.Tensor, block: int = SIGN_BLOCK, *,
                  signs_out: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's function: ``(signs int8 (N,), scale float32 ())``,
    ``scale = mean(|x|)`` from the kernel's per-block partials."""
    signs, partials = sign_compress_partials(x, block, signs_out=signs_out)
    return signs, partials.sum() / max(x.numel(), 1)


sign_compress.launches = 0
