"""Plain PyTorch versions of the port's kernels: what a wrapper runs for a
CPU tensor, and what ``chip_smoke.py`` holds each CUDA kernel against."""
from __future__ import annotations

import torch


def wire_torch_dtype(wire_dtype) -> torch.dtype | None:
    """``None``/``""`` -> ``None``; a dtype name (``"bfloat16"``) or a
    ``torch.dtype`` -> the ``torch.dtype``."""
    if wire_dtype is None or wire_dtype == "":
        return None
    if isinstance(wire_dtype, torch.dtype):
        return wire_dtype
    dt = getattr(torch, str(wire_dtype), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a dtype name: {wire_dtype!r}")
    return dt


def ef_update_ref(g: torch.Tensor, r: torch.Tensor, coeff: float, *,
                  selected: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``t = g + coeff * r`` in two roundings (product, then sum).

    Selected: ``(send, r') = (t, 0)``; unselected: ``(0, t)``.  The same
    function as ``repro.kernels.ref.ef_update_ref`` run eagerly."""
    t = g + coeff * r
    if selected:
        return t, torch.zeros_like(t)
    return torch.zeros_like(t), t


def pack_ef_cast_ref(g: torch.Tensor, r: torch.Tensor | None, coeff, *,
                     selected: bool, wire_dtype=None):
    """Fused pack + error feedback + wire cast, op for op the function of
    ``repro.kernels.ref.pack_ef_cast_ref`` run eagerly.

    ``t = g + coeff * r`` (two roundings; ``r=None`` gives ``t = g``,
    ``coeff=None`` the plain add).  Selected: the wire value is ``t`` cast
    to ``wire_dtype`` (``t`` itself without a cast) and the residual is the
    cast's error ``t - cast(t)`` (zeros without a cast).  Unselected: the
    wire is zeros and the residual is ``t``.  Returns ``(wire, r_new)``;
    ``r_new`` is ``None`` when ``r`` is."""
    if r is None:
        t = g
    elif coeff is None:
        t = g + r.to(g.dtype)
    else:
        t = g + coeff * r.to(g.dtype)
    wd = wire_torch_dtype(wire_dtype)
    if not selected:
        zero = torch.zeros_like(t, dtype=wd if wd is not None else t.dtype)
        return zero, (t if r is not None else None)
    if wd is None or t.dtype == wd:
        return t, (torch.zeros_like(t) if r is not None else None)
    w = t.to(wd)
    return w, (t - w.to(t.dtype) if r is not None else None)


# ---- block-scaled FP8 wire and sign compression ----------------------------

FP8_MAX = 448.0           # float8_e4m3fn's largest finite value
FP8_BLOCK = 8192          # elements per scale
SIGN_BLOCK = 32768        # elements per |x| partial (the TPU kernel's block)


def quantize_fp8_ref(x: torch.Tensor, block: int = FP8_BLOCK
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat ``(N,)`` -> ``(q float8_e4m3fn (N,), scales float32 (nb,))``,
    ``nb = ceil(N / block)``, blocks from element 0.  Per block
    ``scale = max(amax / 448, 1e-12)`` (true division: the divisor is a
    tensor, because PyTorch multiplies by the reciprocal for a Python
    scalar on CUDA) and ``q = e4m3(x / scale)``.  A NaN in a block makes its
    amax and scale NaN.  The function of
    ``repro.kernels.ref.quantize_fp8_ref`` run eagerly, bit for bit."""
    n = x.numel()
    nb = -(-n // block)
    xp = torch.nn.functional.pad(x.reshape(-1).float(), (0, nb * block - n))
    x2 = xp.view(nb, block)
    amax = x2.abs().amax(dim=1)
    scales = torch.clamp_min(amax / torch.full_like(amax, FP8_MAX), 1e-12)
    q = (x2 / scales[:, None]).to(torch.float8_e4m3fn)
    return q.reshape(-1)[:n], scales


def dequantize_fp8_ref(q: torch.Tensor, scales: torch.Tensor,
                       block: int = FP8_BLOCK) -> torch.Tensor:
    """``float32(q[i]) * scales[i // block]``: the conversion is exact and
    the product rounds once."""
    n = q.numel()
    idx = torch.arange(n, device=q.device) // block
    return q.reshape(-1).float() * scales[idx]


def sign_compress_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(int8 signs, float32 scale)``: ``+1`` where ``x >= 0`` (``-0.0``
    included), ``-1`` elsewhere (NaN included); ``scale = mean(|x|)``."""
    signs = torch.where(x >= 0, 1, -1).to(torch.int8)
    return signs, x.float().abs().mean()


def sign_compress_partials_ref(x: torch.Tensor, block: int = SIGN_BLOCK
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function: ``(int8 signs, float32 partials (nb,))``, one
    ``sum(|x|)`` per ``block`` elements; ``scale = partials.sum() / N``."""
    n = x.numel()
    nb = -(-n // block)
    signs = torch.where(x >= 0, 1, -1).to(torch.int8)
    xp = torch.nn.functional.pad(x.reshape(-1).float().abs(), (0, nb * block - n))
    return signs, xp.view(nb, block).sum(dim=1)


def sign_decompress(signs: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return signs.float() * scale


# ---- PowerSGD's low-rank products and the Top-k threshold filter -----------

THRESHOLD_BLOCK = 32768   # elements per survivor count (the TPU kernel's block)


def matmul_ref(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
               trans_b: bool = False) -> torch.Tensor:
    """``A @ B`` in float32 (one ``torch.matmul``), batched over a leading
    axis when the operands are 3-D.  ``trans_a``: ``a`` holds ``A``
    transposed in its last two axes, and is read as such through a view;
    ``trans_b`` likewise for ``b``.  The function of
    ``repro.kernels.ref.matmul_ref`` (which is 2-D) with float32 output."""
    A = a.transpose(-1, -2) if trans_a else a
    B = b.transpose(-1, -2) if trans_b else b
    return torch.matmul(A.float(), B.float())


def threshold_filter_ref(x: torch.Tensor, threshold, block: int = THRESHOLD_BLOCK
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat ``(N,)`` -> ``(y, counts int32 (ceil(N / block),))``: ``y = x``
    where ``|x| >= threshold`` and ``+0.0`` elsewhere (NaN gives 0), and the
    survivors of each ``block`` elements from element 0, padding never
    counted.  The function of ``repro.kernels.ref.threshold_filter_ref``
    run eagerly, bit for bit."""
    keep = x.abs() >= threshold
    y = torch.where(keep, x, torch.zeros_like(x))
    n = x.numel()
    nb = -(-n // block)
    kp = torch.nn.functional.pad(keep.reshape(-1).to(torch.int32), (0, nb * block - n))
    return y, kp.view(nb, block).sum(dim=1, dtype=torch.int32)


def sample_threshold(x: torch.Tensor, ratio: float, sample: int = 4096
                     ) -> torch.Tensor:
    """The ``(1 - ratio)`` quantile of ``|x|`` over a strided sample of
    about ``sample`` elements, as a 0-d tensor on ``x``'s device (the index
    is computed from shapes on the host, so nothing waits for the device).
    ``repro.kernels.topk_threshold.sample_threshold`` bit for bit."""
    n = x.shape[0]
    stride = max(n // sample, 1)
    s = x[::stride].abs()
    k = min(max(int(s.shape[0] * (1.0 - ratio)), 0), s.shape[0] - 1)
    return torch.sort(s).values[k]
