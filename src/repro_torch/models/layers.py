"""Model primitives of the decoders: init, RMSNorm, embedding, RoPE, the
gated MLP and the softcap — the counterparts of ``repro.models.layers``.

Conventions, as in the reference:
* parameters are looked up by name in dict-like containers
  (``nn.ParameterDict`` in the model, plain dicts in tests);
* stacked-layer leaves carry a leading ``(num_superblocks,)`` axis and
  are indexed per superblock by the layer loop;
* matmul inputs are cast to ``compute_dtype`` at the same points as the
  reference (bf16 at full width, f32 on the REDUCED config).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def truncated_normal_init(shape, dtype, generator: torch.Generator, *,
                          device, scale: float = 1.0) -> torch.Tensor:
    """Normal truncated to [-2, 2], scaled by ``scale / sqrt(fan_in)`` with
    ``fan_in = shape[-2]`` (the reference's rule).  The port draws from a
    ``torch.Generator``, so its numbers differ from ``jax.random``'s; tests
    carry the reference's parameters across with ``interop``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(max(fan_in, 1))
    x = torch.empty(shape, dtype=torch.float32, device=device)
    if x.device.type != "meta":
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    # scaled in place: one f32 buffer the size of the leaf, not two (a
    # full-width pixtral-12b MLP leaf is 11.7 GB)
    return x.mul_(std).to(dtype)


def normal_init(shape, dtype, generator: torch.Generator, *, device,
                std: float) -> torch.Tensor:
    x = torch.empty(shape, dtype=torch.float32, device=device)
    if x.device.type != "meta":
        x.normal_(0.0, 1.0, generator=generator)
    return x.mul_(std).to(dtype)


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in f32, cast back."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].float())).to(dt)


def embed(table: torch.Tensor, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return F.embedding(tokens, table.to(compute_dtype))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotation by halves (not interleaved).  x: (..., seq, heads, head_dim);
    positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * (math.log(theta) / half)
    )
    ang = positions[..., :, None].float() * freqs[None, :]
    cos = torch.cos(ang)[..., :, None, :]  # (..., seq, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "swiglu":
        return F.silu(x)
    if name in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def mlp(params, x: torch.Tensor, act: str, compute_dtype) -> torch.Tensor:
    """Gated MLP: ``(act(x W_gate) * (x W_up)) W_down``."""
    xc = x.to(compute_dtype)
    g = xc @ params["w_gate"].to(compute_dtype)
    u = xc @ params["w_up"].to(compute_dtype)
    h = _act(act, g) * u
    return h @ params["w_down"].to(compute_dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(x / cap)`` computed in f32, cast back; the identity
    when ``cap <= 0``."""
    if cap <= 0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
