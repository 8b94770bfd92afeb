"""The MoE block's slot map and row moves on the card: wrapper around the
CUDA kernels in ``csrc/moe_dispatch.cu``.

:func:`moe_dispatch` gives each (token, choice) assignment its slot in the
held experts' ``(E*C, d)`` buffer and each slot the assignment that fills
it: ``(slot, keep, src)``, where ``slot`` and ``keep`` are bit for bit
``models.moe.dispatch``'s and ``src`` is their inverse
(``models.moe.slot_sources``).  :func:`permute` moves the tokens' rows
into the buffer and :func:`unpermute` weights the experts' rows back into
the tokens; each is a ``torch.autograd.Function`` whose backward is a
kernel too.  Rows move only by gathers with unique destinations, and no
kernel uses atomics.

It replaces no TPU kernel: the reference leaves the dispatch to XLA.  The
plain version is ``models.moe``'s (``dispatch``, ``permute_plain``,
``unpermute_plain``), which ``moe_apply`` runs for CPU tensors; this
module takes CUDA tensors only and raises for anything else.

``moe_dispatch.launches`` counts the module's kernel launches, and only
those: two for a slot map, one for each row move and each backward.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

SLOT_THREADS = 1024    # the slot kernels' block: one assignment a thread a pass
MAX_SLOT_BLOCKS = 264  # the slot kernels' grid cap (two blocks an SM)
MAX_EXPERTS = 256      # the held experts the slot kernels' shared counts hold
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def slot_blocks(nk: int) -> tuple[int, int]:
    """``(blocks, assignments a block)`` of the slot kernels for ``nk``
    assignments: whole passes of ``SLOT_THREADS``, at most
    ``MAX_SLOT_BLOCKS`` blocks."""
    passes = max(1, -(-nk // SLOT_THREADS))
    per_block = SLOT_THREADS * -(-passes // MAX_SLOT_BLOCKS)
    return max(1, -(-nk // per_block)), per_block


def _device_check(what: str, *xs: torch.Tensor) -> None:
    dev = xs[0].device
    for x in xs:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"moe_dispatch: {what} needs CUDA tensors on one card, got "
                             f"{[str(t.device) for t in xs]}")


def _contiguous(what: str, **xs: torch.Tensor) -> None:
    for name, x in xs.items():
        if not x.is_contiguous():
            raise ValueError(f"moe_dispatch: {what}'s {name} must be contiguous, got "
                             f"strides {x.stride()}")


def _rows_check(what: str, rows: torch.Tensor, **others: torch.Tensor) -> None:
    if rows.dtype not in DTYPE_CODES:
        raise TypeError(f"moe_dispatch: {what}'s rows must be float32 or bfloat16, got "
                        f"{rows.dtype}")
    for name, x in others.items():
        if x.dtype != rows.dtype:
            raise TypeError(f"moe_dispatch: {what}'s {name} is {x.dtype}, its rows are "
                            f"{rows.dtype}")


def _map_check(what: str, slot: torch.Tensor, src: torch.Tensor, k: int,
               n_slots: int) -> None:
    if slot.dtype != torch.int64 or slot.dim() != 1 or slot.numel() % k:
        raise ValueError(f"moe_dispatch: {what}'s slot must be (N*k,) int64 with k = {k}, "
                         f"got {slot.dtype} {tuple(slot.shape)}")
    if src.dtype != torch.int32 or tuple(src.shape) != (n_slots,):
        raise ValueError(f"moe_dispatch: {what}'s src must be ({n_slots},) int32, got "
                         f"{src.dtype} {tuple(src.shape)}")


def _vec(*xs: torch.Tensor) -> int:
    """1 when every row of ``xs`` may move as 16-byte words: 16-byte aligned
    and a width that is a whole number of them."""
    return int(all(x.data_ptr() % 16 == 0 and (x.shape[-1] * x.element_size()) % 16 == 0
                   for x in xs))


@functools.cache
def _launchers():
    lib = _build.load("moe_dispatch")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    slots = lib.moe_slots_launch
    slots.argtypes = [p, ll, ll, i, i, i, ll, p, p, p, p, p]
    from_src = lib.moe_rows_from_src_launch
    from_src.argtypes = [p] * 7 + [ll, ll, i, i, i, i, p]
    from_slots = lib.moe_rows_from_slots_launch
    from_slots.argtypes = [p] * 4 + [ll, ll, i, i, i, i, p]
    for fn in (slots, from_src, from_slots):
        fn.restype = ctypes.c_int
    return slots, from_src, from_slots


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"moe_dispatch {what} launch failed: cudaError {err}")


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _from_src(rows, slot, src, k: int, w=None, other=None, dw=None):
    """``out[s] = rows[src[s] // k]`` (times ``w[src[s]]``), 0 where
    ``src[s] < 0``; with ``dw`` its weights' gradient from ``other``."""
    n_slots, d = src.numel(), rows.shape[-1]
    out = torch.empty((n_slots, d), dtype=rows.dtype, device=rows.device)
    if n_slots == 0:
        if dw is not None:
            dw.zero_()
        return out
    parts = [rows, out] + [x for x in (other,) if x is not None]
    _, launch, _ = _launchers()
    with torch.cuda.device(rows.device):
        err = launch(rows.data_ptr(), _ptr(w), _ptr(other), slot.data_ptr(), src.data_ptr(),
                     out.data_ptr(), _ptr(dw), n_slots, slot.numel(), k, d,
                     DTYPE_CODES[rows.dtype], _vec(*parts), _stream(rows))
    _raise_on(err, "rows_from_src")
    moe_dispatch.launches += 1
    return out


def _from_slots(rows, slot, k: int, w=None):
    """``out[t] = sum_j rows[slot[t*k + j]]`` (each times ``w[t*k + j]``)
    over the kept ``j``, an f32 sum rounded once."""
    n_tokens, d = slot.numel() // k, rows.shape[-1]
    out = torch.empty((n_tokens, d), dtype=rows.dtype, device=rows.device)
    if n_tokens == 0:
        return out
    _, _, launch = _launchers()
    with torch.cuda.device(rows.device):
        err = launch(rows.data_ptr(), _ptr(w), slot.data_ptr(), out.data_ptr(), n_tokens,
                     rows.shape[0], k, d, DTYPE_CODES[rows.dtype], _vec(rows, out),
                     _stream(rows))
    _raise_on(err, "rows_from_slots")
    moe_dispatch.launches += 1
    return out


def moe_dispatch(top_e: torch.Tensor, first_expert: int, num_experts: int,
                 capacity: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slot map of the assignments ``top_e`` (N, k) int64 to the
    ``num_experts`` experts from ``first_expert`` on, each of ``capacity``
    slots, token-major: ``(slot (N*k,) int64, keep (N*k,) bool, src (E*C,)
    int32)``.  An assignment is kept when its expert is held and fewer than
    ``capacity`` assignments before it, earlier tokens and then earlier
    choices, went to that expert; one not kept has slot ``E*C``; an empty
    slot has src -1.  Launches on the current stream and does not
    synchronise."""
    E, C = int(num_experts), int(capacity)
    if top_e.dtype != torch.int64 or top_e.dim() != 2:
        raise ValueError(f"moe_dispatch: top_e must be (N, k) int64, got {top_e.dtype} "
                         f"{tuple(top_e.shape)}")
    _contiguous("the slot map", top_e=top_e)
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"moe_dispatch: {E} held experts, the kernels hold 1..{MAX_EXPERTS}")
    if C < 1:
        raise ValueError(f"moe_dispatch: capacity {C} must be >= 1")
    nk = top_e.numel()
    if nk >= 2**31 or E * C >= 2**31:
        raise ValueError(f"moe_dispatch: {nk} assignments and {E * C} slots must each "
                         f"be below 2**31")
    _device_check("the slot map", top_e)
    dev = top_e.device
    slot = torch.empty(nk, dtype=torch.int64, device=dev)
    keep = torch.empty(nk, dtype=torch.bool, device=dev)
    src = torch.empty(E * C, dtype=torch.int32, device=dev)
    if nk == 0:
        return slot, keep, src.fill_(-1)
    blocks, per_block = slot_blocks(nk)
    counts = torch.empty(blocks * E, dtype=torch.int32, device=dev)
    launch, _, _ = _launchers()
    with torch.cuda.device(dev):
        err = launch(top_e.data_ptr(), nk, int(first_expert), E, C, blocks, per_block,
                     counts.data_ptr(), slot.data_ptr(), keep.data_ptr(), src.data_ptr(),
                     _stream(top_e))
    _raise_on(err, "slot map")
    moe_dispatch.launches += 2
    return slot, keep, src


moe_dispatch.launches = 0


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slot, src, k: int):
        ctx.save_for_backward(slot)
        ctx.k = k
        return _from_src(x, slot, src, k)

    @staticmethod
    def backward(ctx, dbuf):
        (slot,) = ctx.saved_tensors
        return _from_slots(dbuf.contiguous(), slot, ctx.k), None, None, None


class _Unpermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, w, slot, src, k: int):
        # the rows only for the weights' gradient
        ctx.save_for_backward(rows if ctx.needs_input_grad[1] else None, w, slot, src)
        ctx.k = k
        return _from_slots(rows, slot, k, w)

    @staticmethod
    def backward(ctx, dy):
        rows, w, slot, src = ctx.saved_tensors
        dw = torch.empty_like(w) if ctx.needs_input_grad[1] else None
        drows = _from_src(dy.contiguous(), slot, src, ctx.k, w=w, other=rows, dw=dw)
        return drows, dw, None, None, None


def permute(x: torch.Tensor, slot: torch.Tensor, src: torch.Tensor, k: int,
            num_experts: int, capacity: int) -> torch.Tensor:
    """The held experts' buffer ``(E, C, d)`` of the tokens' rows ``x`` (N,
    d): slot ``s`` holds ``x[src[s] // k]``, an empty slot zeros; ``(slot,
    keep, src)`` from :func:`moe_dispatch`.  Its backward sums each token's
    kept slots' gradients, j = 0..k-1, in f32 rounded once."""
    E, C, k = int(num_experts), int(capacity), int(k)
    if x.dim() != 2:
        raise ValueError(f"moe_dispatch: permute's x must be (N, d), got {tuple(x.shape)}")
    _rows_check("permute", x)
    _map_check("permute", slot, src, k, E * C)
    if slot.numel() != x.shape[0] * k:
        raise ValueError(f"moe_dispatch: permute's slot has {slot.numel()} assignments, "
                         f"x has {x.shape[0]} tokens of k = {k}")
    _contiguous("permute", x=x, slot=slot, src=src)
    _device_check("permute", x, slot, src)
    return _Permute.apply(x, slot, src, k).view(E, C, x.shape[1])


def unpermute(rows: torch.Tensor, w: torch.Tensor, slot: torch.Tensor,
              src: torch.Tensor, k: int) -> torch.Tensor:
    """The tokens' outputs ``(N, d)`` from the experts' rows ``rows`` (E*C,
    d): ``y[t] = sum_j dtype(rows[slot[t*k + j]] * w[t*k + j])`` over the
    kept ``j``, in f32 rounded once; ``w`` (N*k,) in the rows' dtype.
    Differentiable in ``rows`` and ``w``."""
    k = int(k)
    if rows.dim() != 2:
        raise ValueError(f"moe_dispatch: unpermute's rows must be (E*C, d), got "
                         f"{tuple(rows.shape)}")
    _rows_check("unpermute", rows, w=w)
    _map_check("unpermute", slot, src, k, rows.shape[0])
    if tuple(w.shape) != tuple(slot.shape):
        raise ValueError(f"moe_dispatch: unpermute's w {tuple(w.shape)} does not match "
                         f"slot {tuple(slot.shape)}")
    _contiguous("unpermute", rows=rows, w=w, slot=slot, src=src)
    _device_check("unpermute", rows, w, slot, src)
    return _Unpermute.apply(rows, w, slot, src, k)
