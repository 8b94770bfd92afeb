"""Mamba2 (SSD) block — the counterpart of ``repro.models.ssm``: the chunked
scan for training and prefill, and the O(1)-state recurrence for decode.
zamba2 (the hybrid family) stacks it.

State space (per head h, scalar decay a_t = exp(dt_t * A_h)):

    H_t = a_t * H_{t-1} + dt_t * x_t (x) B_t        H: (hd, ds)
    y_t = C_t . H_t + D * x_t

Training uses the SSD chunk decomposition: an intra-chunk term through the
decay matrix L, an inter-chunk term through the carried state.  As in the
reference, the input projection is split into ``wz``/``wx``/``wB``/``wC``/
``wdt``, each channel group with its own depthwise causal conv.

Two departures from the reference's arithmetic, neither of which changes
a forward value:

* L's entries above the diagonal are ``exp(-inf) = 0`` (the reference
  takes ``exp`` of the positive log-decays there and masks after, so at a
  chunk of 128 the ``exp`` overflows and its gradient, 0 x inf, is NaN);
* the three-operand contractions are written as pairwise products, so no
  (B, c, H, hd, ds) or (B, c, c, H, hd) intermediate is built.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rmsnorm

# leaves kept in float32 whatever the parameter dtype, as the reference
# initialises them
F32_LEAVES = frozenset({"wdt", "A_log", "D", "dt_bias"})


def ssm_dims(cfg) -> tuple[int, int, int]:
    """``(d_inner, heads, state)`` of the SSD block."""
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return d_in, H, cfg.ssm_state


def ssm_param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """One block's ``ssm.*`` leaf shapes (one row), by name."""
    d = cfg.d_model
    d_in, H, ds = ssm_dims(cfg)
    k = cfg.ssm_conv
    return {
        "wz": (d, d_in), "wx": (d, d_in), "wB": (d, ds), "wC": (d, ds),
        "wdt": (d, H),
        "conv_x": (k, d_in), "conv_x_b": (d_in,),
        "conv_B": (k, ds), "conv_B_b": (ds,),
        "conv_C": (k, ds), "conv_C_b": (ds,),
        "A_log": (H,), "D": (H,), "dt_bias": (H,),
        "norm.scale": (d_in,), "out_proj": (d_in, d),
    }


def leaf_init(name: str):
    """The reference's init of an ``ssm.*`` leaf: ``("const", v)``,
    ``("normal", std)`` or ``("trunc", scale)``; ``None`` for the model's
    default rule (a truncated normal matrix, a zero norm scale)."""
    if name in ("A_log", "dt_bias"):
        return ("const", 0.0)
    if name == "D":
        return ("const", 1.0)
    if name == "wdt":
        return ("trunc", 0.1)
    if name.startswith("conv_"):
        return ("const", 0.0) if name.endswith("_b") else ("normal", 0.1)
    return None


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, ch); w: (k, ch); b: (ch,).  Depthwise causal conv of width
    k (left pad k - 1), a cross-correlation as ``lax.conv_general_dilated``
    computes it: ``y[t] = sum_j w[j] * x[t + j - (k - 1)]``."""
    k, ch = w.shape
    xt = F.pad(x.transpose(1, 2), (k - 1, 0))
    y = F.conv1d(xt, w.to(x.dtype).t().unsqueeze(1), groups=ch)
    return y.transpose(1, 2) + b.to(x.dtype)


def _proj(params, name, x, cd):
    return x.to(cd) @ params[name].to(cd)


def ssm_train(params, x: torch.Tensor, cfg, *, chunk: int = 128) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), the SSD scan in chunks of ``chunk`` (the
    whole sequence when it does not divide)."""
    B, S, _ = x.shape
    d_in, H, ds = ssm_dims(cfg)
    hd = cfg.ssm_head_dim
    cd = getattr(torch, cfg.compute_dtype)

    z = _proj(params, "wz", x, cd)
    xs = F.silu(_causal_conv(_proj(params, "wx", x, cd), params["conv_x"],
                             params["conv_x_b"]))
    Bv = F.silu(_causal_conv(_proj(params, "wB", x, cd), params["conv_B"],
                             params["conv_B_b"])).float()
    Cv = F.silu(_causal_conv(_proj(params, "wC", x, cd), params["conv_C"],
                             params["conv_C_b"])).float()
    dt = _proj(params, "wdt", x, torch.float32)

    xs = xs.reshape(B, S, H, hd)
    dt = F.softplus(dt + params["dt_bias"])          # (B, S, H)
    A = -torch.exp(params["A_log"])                  # (H,)
    dA = dt * A                                      # log-decay

    c = min(chunk, S)
    if S % c != 0:
        c = S
    above = ~torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    xf = xs.float()
    h = x.new_zeros((B, H, hd, ds), dtype=torch.float32)
    ys = []
    for off in range(0, S, c):
        sl = slice(off, off + c)
        xk, Bk, Ck, dtk = xf[:, sl], Bv[:, sl], Cv[:, sl], dt[:, sl]
        cum = torch.cumsum(dA[:, sl], dim=1)                     # (B, c, H)
        # intra-chunk: L_ij = exp(cum_i - cum_j) for i >= j, else 0
        diff = cum[:, :, None, :] - cum[:, None, :, :]           # (B, c, c, H)
        L = torch.exp(diff.masked_fill(above[None, :, :, None], float("-inf")))
        G = Ck @ Bk.transpose(1, 2)                              # (B, c, c)
        dtx = dtk[..., None] * xk                                # (B, c, H, hd)
        W = (G[..., None] * L).permute(0, 3, 1, 2)               # (B, H, c, c)
        y_intra = W @ dtx.permute(0, 2, 1, 3)                    # (B, H, c, hd)
        # inter-chunk: the carried state read through C, decayed to i
        y_inter = (h @ Ck[:, None].transpose(2, 3)).permute(0, 3, 1, 2)  # (B, c, H, hd)
        y_inter = y_inter * torch.exp(cum)[..., None]
        ys.append(y_intra.permute(0, 2, 1, 3) + y_inter)
        # state update: decay the old state over the chunk, add each token's
        # dt x (x) B decayed to the chunk's end
        tail = torch.exp(cum[:, -1:, :] - cum)                   # (B, c, H)
        scaled = (dtx * tail[..., None]).permute(0, 2, 3, 1)     # (B, H, hd, c)
        h = torch.exp(cum[:, -1])[:, :, None, None] * h + scaled @ Bk[:, None]
    y = torch.cat(ys, dim=1)                                     # (B, S, H, hd)
    y = y + params["D"][None, None, :, None] * xf
    y = y.reshape(B, S, d_in).to(cd)
    y = y * F.silu(z)
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    return y @ params["out_proj"].to(cd)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def ssm_state_init(cfg, batch: int, *, device) -> dict:
    """Zero decode state of one block: the SSD state ``h`` and the last
    ``k - 1`` conv inputs of each channel group, all float32; shapes only
    on the ``meta`` device."""
    d_in, H, ds = ssm_dims(cfg)
    k = cfg.ssm_conv
    z = lambda *s: torch.zeros((batch,) + s, dtype=torch.float32, device=device)
    return {
        "h": z(H, cfg.ssm_head_dim, ds),
        "conv_x": z(k - 1, d_in),
        "conv_B": z(k - 1, ds),
        "conv_C": z(k - 1, ds),
    }


def _conv_step(state_buf, new, w, b):
    """state_buf: (B, k-1, ch); new: (B, ch) -> (out (B, ch), new_buf)."""
    window = torch.cat([state_buf, new[:, None, :]], dim=1)  # (B, k, ch)
    out = (window * w.float()).sum(1) + b.float()
    return out, window[:, 1:, :]


def ssm_decode(params, x: torch.Tensor, state: dict, cfg):
    """x: (B, 1, d) -> ``(y (B, 1, d), new_state)``; ``state`` is read, not
    written."""
    B = x.shape[0]
    d_in, H, ds = ssm_dims(cfg)
    hd = cfg.ssm_head_dim
    cd = getattr(torch, cfg.compute_dtype)
    f32 = torch.float32

    z = _proj(params, "wz", x, cd)
    x_new = _proj(params, "wx", x, f32)[:, 0]
    B_new = _proj(params, "wB", x, f32)[:, 0]
    C_new = _proj(params, "wC", x, f32)[:, 0]
    dt = _proj(params, "wdt", x, f32)[:, 0]

    xo, conv_x = _conv_step(state["conv_x"], x_new, params["conv_x"], params["conv_x_b"])
    Bo, conv_B = _conv_step(state["conv_B"], B_new, params["conv_B"], params["conv_B_b"])
    Co, conv_C = _conv_step(state["conv_C"], C_new, params["conv_C"], params["conv_C_b"])
    xs = F.silu(xo).reshape(B, H, hd)
    Bv = F.silu(Bo)
    Cv = F.silu(Co)

    dtv = F.softplus(dt + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    a = torch.exp(dtv * A)                                        # (B, H)
    h_new = (a[:, :, None, None] * state["h"]
             + (dtv[:, :, None] * xs)[..., None] * Bv[:, None, None, :])
    y = (h_new @ Cv[:, None, :, None])[..., 0]                    # (B, H, hd)
    y = y + params["D"][None, :, None] * xs
    y = y.reshape(B, 1, d_in).to(cd)
    y = y * F.silu(z)
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    y = y @ params["out_proj"].to(cd)
    return y, {"h": h_new, "conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C}
