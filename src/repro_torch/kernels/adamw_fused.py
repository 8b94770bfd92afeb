"""AdamW's step over a model's leaves, in place: wrapper around the CUDA
kernel in ``csrc/adamw_fused.cu``, one launch a leaf.

It replaces no kernel of the reference.  Per element it computes what
``optim.adamw``'s ``update`` followed by ``optim.apply_updates`` computes,
with the same roundings, and writes p, m and v where they lie; with
``norm=True`` each launch also gives its blocks' sums of ``g * g``, and one
fixed-order sum of them and a root give the gradients' global norm.  The
plain version is that ``update`` + ``apply_updates`` pair (and
``optim.global_norm``), which ``Optimizer.apply`` runs for CPU tensors;
this wrapper takes CUDA tensors only and raises for anything else.

``adamw_fused.launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

THREADS = 256          # the kernel's block
ELEMS_PER_THREAD = 8   # a thread's elements per pass of its vector loop
BLOCKS_PER_SM = 4      # the grid's cap, per SM: the kernel's __launch_bounds__ minimum
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def grid(n: int, sms: int) -> int:
    """The blocks a leaf of ``n`` elements is launched with on a card of
    ``sms`` SMs: one per ``THREADS * ELEMS_PER_THREAD`` elements, at most
    ``BLOCKS_PER_SM`` an SM (0 for an empty leaf, which is not launched)."""
    per_block = THREADS * ELEMS_PER_THREAD
    return min(-(-n // per_block), sms * BLOCKS_PER_SM)


def _check(i: int, p, g, m, v, bc1, bc2) -> None:
    where = f"adamw_fused: leaf {i}"
    for name, x in (("p", p), ("g", g), ("m", m), ("v", v)):
        if x.dtype not in DTYPE_CODES:
            raise TypeError(f"{where}: {name} must be float32 or bfloat16, got "
                            f"{x.dtype}")
        if x.shape != p.shape:
            raise ValueError(f"{where}: {name} has shape {tuple(x.shape)}, p has "
                             f"{tuple(p.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{where}: {name} must be contiguous, got strides "
                             f"{x.stride()}")
        if x.device != p.device:
            raise ValueError(f"{where}: {name} on {x.device}, p on {p.device}")
    if m.dtype != v.dtype:
        raise TypeError(f"{where}: m is {m.dtype}, v is {v.dtype}")
    if p.device.type != "cuda":
        raise ValueError(f"{where}: needs CUDA tensors, got tensors on {p.device}")
    for name, bc in (("bc1", bc1), ("bc2", bc2)):
        if bc.dim() != 0 or bc.dtype != torch.float32 or bc.device != p.device:
            raise ValueError(f"{where}: {name} must be a 0-dim float32 tensor on "
                             f"{p.device}, got {bc.dtype} of shape {tuple(bc.shape)} "
                             f"on {bc.device}")


@functools.cache
def _launcher():
    fn = _build.load("adamw_fused").adamw_fused_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
        ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def adamw_fused(params: list[torch.Tensor], grads: list[torch.Tensor],
                m: list[torch.Tensor], v: list[torch.Tensor],
                bc1: torch.Tensor, bc2: torch.Tensor, *, lr: float, b1: float,
                b2: float, eps: float, weight_decay: float,
                norm: bool = False) -> torch.Tensor | None:
    """One AdamW step at learning rate ``lr``, in place on ``params``, ``m``
    and ``v`` (leaf lists of one length, each leaf f32 or bf16, ``m[i]`` and
    ``v[i]`` of one dtype; ``bc1``, ``bc2`` the step's 0-dim float32 bias
    corrections on the same card).  -> the gradients' global norm as a
    0-dim float32 tensor on the card with ``norm=True``, else None.
    Launches on the current stream and does not synchronise."""
    if not params:
        raise ValueError("adamw_fused: no leaves")
    if not len(params) == len(grads) == len(m) == len(v):
        raise ValueError(f"adamw_fused: {len(params)} params, {len(grads)} grads, "
                         f"{len(m)} m and {len(v)} v")
    for i, leaf in enumerate(zip(params, grads, m, v)):
        _check(i, *leaf, bc1, bc2)
    device = params[0].device
    blocks = [grid(p.numel(), _sm_count(device.index)) for p in params]
    partials = (torch.empty(sum(blocks), dtype=torch.float32, device=device)
                if norm else None)
    launch = _launcher()
    hyper = (b1, 1 - b1, b2, 1 - b2, eps, weight_decay, int(bool(weight_decay)), -lr)
    offset = 0
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for p, g, mi, vi, nb in zip(params, grads, m, v, blocks):
            if nb == 0:
                continue
            out = partials.data_ptr() + 4 * offset if norm else None
            err = launch(p.data_ptr(), g.data_ptr(), mi.data_ptr(), vi.data_ptr(),
                         bc1.data_ptr(), bc2.data_ptr(), *hyper, p.numel(), nb,
                         DTYPE_CODES[p.dtype], DTYPE_CODES[g.dtype],
                         DTYPE_CODES[mi.dtype], out, stream)
            if err != 0:
                raise RuntimeError(f"adamw_fused kernel launch failed: cudaError {err}")
            adamw_fused.launches += 1
            offset += nb
    if not norm:
        return None
    return torch.sqrt(partials.sum())


adamw_fused.launches = 0
