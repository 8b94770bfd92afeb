"""The Top-k / DGC threshold filter: wrapper around the CUDA kernel in
``csrc/threshold_filter.cu`` (the port of
``repro.kernels.topk_threshold.threshold_filter``), and the plain
:func:`~repro_torch.kernels.ref.sample_threshold` that estimates its
threshold.

:func:`threshold_filter` keeps ``x`` where ``|x| >= threshold`` (``+0.0``
elsewhere, NaN included) and counts the survivors of each ``block``
elements, real elements only.  The threshold is a device scalar that the
kernel reads through a pointer, so the host never waits for it.  For CUDA
tensors it launches the kernel or raises; for CPU tensors it runs
:func:`~repro_torch.kernels.ref.threshold_filter_ref`.  The two agree bit
for bit.

No compressor of the port calls it: the reference's ``TopK`` and ``DGC``
select exactly k elements with ``lax.top_k``, and a sampled threshold keeps
about k.  ``repro_torch.kernels.ops`` exposes it, as ``repro.kernels.ops``
does.

``threshold_filter.launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .quantize import _check_block, _check_flat, num_blocks
from .ref import THRESHOLD_BLOCK, sample_threshold, threshold_filter_ref

__all__ = ["sample_threshold", "threshold_filter"]


@functools.cache
def _launcher():
    fn = _build.load("threshold_filter").threshold_filter_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def threshold_filter(x: torch.Tensor, threshold, *, block: int = THRESHOLD_BLOCK
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x``: flat ``(N,)`` float32; ``threshold``: a one-element tensor (on
    ``x``'s device for CUDA tensors, where a float32 scalar is read in
    place) or a Python number.  Returns ``(y float32 (N,), counts int32
    (ceil(N / block),))``."""
    fn = "threshold_filter"
    block = _check_block(fn, block)
    _check_flat(fn, "x", x, torch.float32)
    if x.device.type != "cuda":
        return threshold_filter_ref(x, threshold, block)
    if isinstance(threshold, torch.Tensor):
        if threshold.numel() != 1:
            raise ValueError(f"{fn}: threshold must hold one value, got shape "
                             f"{tuple(threshold.shape)}")
        if threshold.device != x.device:
            raise ValueError(f"{fn}: threshold on {threshold.device}, x on {x.device}")
        t = threshold.reshape(1).to(torch.float32)
    else:
        t = torch.full((1,), float(threshold), dtype=torch.float32, device=x.device)
    n = x.numel()
    y = torch.empty_like(x)
    counts = torch.empty(num_blocks(n, block), dtype=torch.int32, device=x.device)
    if n == 0:
        return y, counts
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(x.data_ptr(), t.data_ptr(), y.data_ptr(), counts.data_ptr(),
                          n, block, stream)
    if err != 0:
        raise RuntimeError(f"threshold_filter kernel launch failed: cudaError {err}")
    threshold_filter.launches += 1
    return y, counts


threshold_filter.launches = 0
