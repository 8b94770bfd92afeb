"""xLSTM blocks (Beck et al., arXiv:2405.04517) — the counterpart of
``repro.models.xlstm``: mLSTM (matrix memory) and sLSTM (scalar memory, a
true recurrence with block-diagonal recurrent weights), with exponential
gating and the max-stabiliser state m.  xlstm-125m (the ssm family) stacks
them.

Training and prefill run a loop over tokens, as the reference's
``lax.scan`` does; decode carries the ``(C, n, m)`` / ``(c, n, m, h)``
states, O(1) per token.  The mLSTM's state update adds the outer product
``(i v) k^T`` with ``torch.addcmul``, so the backward pass saves the two
vectors and not the (B, H, hd, hd) product: it keeps one state ``C`` a
token, no more.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rmsnorm

# leaves kept in float32 whatever the parameter dtype, as the reference
# initialises them
MLSTM_F32 = frozenset({"wi", "wf", "bi", "bf"})
SLSTM_F32 = frozenset({"bi", "bf", "bz", "bo"})
GATES = ("i", "f", "z", "o")


def _dims(cfg) -> tuple[int, int, int, int]:
    """``(d, d_inner, heads, head_dim)`` of the mLSTM (expansion 2)."""
    d = cfg.d_model
    d_in = 2 * d
    H = cfg.num_heads
    return d, d_in, H, d_in // H


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    d, d_in, H, _ = _dims(cfg)
    return {
        "norm.scale": (d,), "up_x": (d, d_in), "up_z": (d, d_in),
        "wq": (d_in, d_in), "wk": (d_in, d_in), "wv": (d_in, d_in),
        "wi": (d_in, H), "wf": (d_in, H), "bi": (H,), "bf": (H,),
        "out_norm.scale": (d_in,), "down": (d_in, d),
    }


def mlstm_leaf_init(name: str):
    """The reference's init of an mLSTM leaf (see ``ssm.leaf_init``):
    the gate weights at scale 0.1, the forget bias 3 (open at init)."""
    if name in ("wi", "wf"):
        return ("trunc", 0.1)
    if name == "bi":
        return ("const", 0.0)
    if name == "bf":
        return ("const", 3.0)
    return None


def _mlstm_precompute(params, x, cfg):
    _, _, H, hd = _dims(cfg)
    cd = getattr(torch, cfg.compute_dtype)
    B, S = x.shape[:2]
    xn = rmsnorm(params["norm"], x, cfg.norm_eps).to(cd)
    xm = xn @ params["up_x"].to(cd)
    z = xn @ params["up_z"].to(cd)
    q = (xm @ params["wq"].to(cd)).reshape(B, S, H, hd).float()
    k = (xm @ params["wk"].to(cd)).reshape(B, S, H, hd).float() * (hd ** -0.5)
    v = (xm @ params["wv"].to(cd)).reshape(B, S, H, hd).float()
    xf = xm.float()
    ig = xf @ params["wi"] + params["bi"]
    fg = xf @ params["wf"] + params["bf"]
    return q, k, v, ig, fg, z


def _mlstm_cell(state, q, k, v, ig, fg):
    """One token of the stabilised mLSTM recurrence.  state: ``C`` (B, H,
    hd, hd), ``n`` (B, H, hd), ``m`` (B, H); q, k, v: (B, H, hd); ig, fg:
    (B, H)."""
    C, n, m = state
    m_new = torch.maximum(fg + m, ig)
    fp = torch.exp(fg + m - m_new)[..., None]
    ip = torch.exp(ig - m_new)[..., None]
    C_new = torch.addcmul(fp[..., None] * C, (ip * v)[..., :, None], k[..., None, :])
    n_new = fp * n + ip * k
    num = (C_new @ q[..., None])[..., 0]
    den = torch.clamp(torch.abs((n_new * q).sum(-1)), min=1.0)
    return (C_new, n_new, m_new), num / den[..., None]


def _mlstm_out(params, h, z, cfg):
    cd = getattr(torch, cfg.compute_dtype)
    h = rmsnorm(params["out_norm"], h.to(cd), cfg.norm_eps)
    h = h * F.silu(z)
    return h @ params["down"].to(cd)


def mlstm_train(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), the recurrence token by token."""
    _, d_in, H, hd = _dims(cfg)
    B, S = x.shape[:2]
    q, k, v, ig, fg, z = _mlstm_precompute(params, x, cfg)
    f32 = dict(dtype=torch.float32, device=x.device)
    state = (torch.zeros((B, H, hd, hd), **f32), torch.zeros((B, H, hd), **f32),
             torch.zeros((B, H), **f32))
    hs = []
    for t in range(S):
        state, h = _mlstm_cell(state, q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, d_in)
    return _mlstm_out(params, h, z, cfg)


def mlstm_state_init(cfg, batch: int, *, device) -> dict:
    _, _, H, hd = _dims(cfg)
    z = lambda *s: torch.zeros((batch,) + s, dtype=torch.float32, device=device)
    return {"C": z(H, hd, hd), "n": z(H, hd), "m": z(H)}


def mlstm_decode(params, x: torch.Tensor, state: dict, cfg):
    """x: (B, 1, d) -> ``(y (B, 1, d), new_state)``."""
    _, d_in, _, _ = _dims(cfg)
    B = x.shape[0]
    q, k, v, ig, fg, z = _mlstm_precompute(params, x, cfg)
    st, h = _mlstm_cell((state["C"], state["n"], state["m"]),
                        q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0])
    y = _mlstm_out(params, h.reshape(B, 1, d_in), z, cfg)
    return y, {"C": st[0], "n": st[1], "m": st[2]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    shapes = {"norm.scale": (d,), "down": (d, d)}
    for g in GATES:
        shapes.update({f"w{g}": (d, d), f"r{g}": (H, hd, hd), f"b{g}": (d,)})
    return shapes


def slstm_leaf_init(name: str):
    """The reference's init of an sLSTM leaf: the recurrent weights at
    scale 0.5 (fan-in ``hd``), the forget bias 3, the other biases 0."""
    if name in ("ri", "rf", "rz", "ro"):
        return ("trunc", 0.5)
    if name == "bf":
        return ("const", 3.0)
    if name in SLSTM_F32:
        return ("const", 0.0)
    return None


def _slstm_inputs(params, x, cfg):
    H = cfg.num_heads
    hd = cfg.d_model // H
    cd = getattr(torch, cfg.compute_dtype)
    B, S = x.shape[:2]
    xn = rmsnorm(params["norm"], x, cfg.norm_eps).to(cd)
    return {g: ((xn @ params[f"w{g}"].to(cd)).float() + params[f"b{g}"]).reshape(B, S, H, hd)
            for g in GATES}


def _slstm_cell(r, state, xg):
    """One token.  r: the four recurrent weights (H, hd, hd) as f32;
    state: ``(c, n, m, h)``, each (B, H, hd); xg: the four input-side
    pre-activations of this token."""
    c, n, m, h = state
    hr = h.unsqueeze(2)                                 # (B, H, 1, hd)
    rec = {g: xg[g] + (hr @ r[g])[:, :, 0] for g in GATES}
    it, ft = rec["i"], rec["f"]
    zt = torch.tanh(rec["z"])
    ot = torch.sigmoid(rec["o"])
    m_new = torch.maximum(ft + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(ft + m - m_new)
    c_new = fp * c + ip * zt
    n_new = fp * n + ip
    h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h_new), h_new


def _slstm_r(params):
    return {g: params[f"r{g}"].float() for g in GATES}


def slstm_train(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), the recurrence token by token."""
    H = cfg.num_heads
    d = cfg.d_model
    hd = d // H
    cd = getattr(torch, cfg.compute_dtype)
    B, S = x.shape[:2]
    xg = _slstm_inputs(params, x, cfg)
    r = _slstm_r(params)
    zero = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    state = (zero, zero, zero, zero)
    hs = []
    for t in range(S):
        state, h = _slstm_cell(r, state, {g: xg[g][:, t] for g in GATES})
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, d).to(cd)
    return h @ params["down"].to(cd)


def slstm_state_init(cfg, batch: int, *, device) -> dict:
    H = cfg.num_heads
    hd = cfg.d_model // H
    return {k: torch.zeros((batch, H, hd), dtype=torch.float32, device=device)
            for k in ("c", "n", "m", "h")}


def slstm_decode(params, x: torch.Tensor, state: dict, cfg):
    """x: (B, 1, d) -> ``(y (B, 1, d), new_state)``."""
    cd = getattr(torch, cfg.compute_dtype)
    B = x.shape[0]
    xg = _slstm_inputs(params, x, cfg)
    st, h = _slstm_cell(_slstm_r(params), (state["c"], state["n"], state["m"], state["h"]),
                        {g: xg[g][:, 0] for g in GATES})
    y = h.reshape(B, 1, cfg.d_model).to(cd) @ params["down"].to(cd)
    return y, dict(zip(("c", "n", "m", "h"), st))
