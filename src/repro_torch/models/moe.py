"""Mixture-of-Experts FFN: top-k router and shared experts (DeepSeekMoE's
fine-grained experts; also Grok-1's 8 experts, top-2) — the counterpart of
``repro.models.moe``, with its semantics kept exactly.

Dispatch is capacity-based gather/scatter with static shapes:

    tokens -> f32 router, softmax, top-k, renormalised ->
    position-in-expert from a cumsum over the token-major (N*k) order ->
    scatter into (E, C, d) buffers -> batched expert matmuls ->
    gather back, weighted by the router probabilities.

An assignment past capacity ``C = ceil(N*k/E * capacity_factor)`` (over
this worker's ``N`` tokens) is dropped: earlier tokens, and within a token
the higher-probability choice, win a full expert; while a profiler
records, the counters ``moe/assigned`` and ``moe/dropped`` (``obs.spans``)
add up the assignments and the dropped ones.  The Switch-style aux
loss uses ``mean(probs)`` and the first choice's one-hot.  The routed
experts use ``silu(g) * u`` whatever ``mlp_act`` is; the shared experts
are one ``mlp(..., cfg.mlp_act)`` of width ``d_ff * num_shared_experts``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..obs.spans import count, recording, span
from .layers import mlp


def moe_param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Shapes of one block's ``moe`` leaves, keyed by their path under it."""
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    shapes = {
        "router": (d, E),
        "w_gate": (E, d, ff),
        "w_up": (E, d, ff),
        "w_down": (E, ff, d),
    }
    if cfg.num_shared_experts > 0:
        fs = ff * cfg.num_shared_experts
        shapes.update({"shared.w_gate": (d, fs), "shared.w_up": (d, fs),
                       "shared.w_down": (fs, d)})
    return shapes


# the router's parameter dtype and init scale, whatever the config's
ROUTER_DTYPE = torch.float32
ROUTER_INIT_SCALE = 0.1


def capacity(cfg, n_tokens: int) -> int:
    """Per-expert capacity ``C`` for ``n_tokens`` tokens on one worker."""
    return int(math.ceil(n_tokens * cfg.experts_per_token / cfg.num_experts
                         * cfg.moe_capacity_factor))


def route(params, xt: torch.Tensor, cfg):
    """The f32 router over tokens ``xt`` (N, d) -> ``(probs (N, E), top_p
    (N, k) renormalised, top_e (N, k), aux)``."""
    E, k = cfg.num_experts, cfg.experts_per_token
    logits = xt.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / (torch.sum(top_p, dim=-1, keepdim=True) + 1e-9)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(top_e[:, 0], E).float(), dim=0)
    aux = cfg.aux_loss_coef * E * torch.sum(me * ce)
    return probs, top_p, top_e, aux


def dispatch(top_e: torch.Tensor, cfg, C: int):
    """Each assignment's slot in the (E*C) expert buffer, token-major:
    ``(slot, keep)``, with a dropped assignment at slot ``E*C``."""
    E = cfg.num_experts
    eid = top_e.reshape(-1)
    onehot = F.one_hot(eid, E)
    pos = torch.gather(torch.cumsum(onehot, dim=0) - 1, 1, eid[:, None])[:, 0]
    keep = pos < C
    slot = torch.where(keep, eid * C + pos, torch.full_like(eid, E * C))
    return slot, keep


def moe_apply(params, x: torch.Tensor, cfg):
    """x: (B, S, d) -> (y, aux_loss)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    cd = getattr(torch, cfg.compute_dtype)
    N = B * S
    xt = x.reshape(N, d)

    with span("moe/route"):
        _, top_p, top_e, aux = route(params, xt, cfg)
    with span("moe/dispatch"):
        C = capacity(cfg, N)
        slot, keep = dispatch(top_e, cfg, C)
        w = top_p.reshape(-1).to(cd)
        if recording():
            count("moe/assigned", keep.numel())
            # summed after the profiled window: no launch inside the step
            count("moe/dropped", lambda keep=keep: (~keep).sum())
        # each token's row k times, token-major (the reference's
        # ``xt[repeat(arange(N), k)]``): an expand, whose backward sums each
        # token's k rows in a fixed order, where an index's would scatter-add
        rows = xt.to(cd)[:, None, :].expand(N, k, d).reshape(N * k, d)
        # one spare row takes every dropped assignment; it is cut off
        buf = torch.zeros((E * C + 1, d), dtype=cd, device=x.device)
        buf = buf.index_put((slot,), rows)[:E * C].reshape(E, C, d)

    with span("moe/experts"):
        g = torch.bmm(buf, params["w_gate"].to(cd))
        u = torch.bmm(buf, params["w_up"].to(cd))
        h = F.silu(g) * u
        out_buf = torch.bmm(h, params["w_down"].to(cd)).reshape(E * C, d)

    with span("moe/combine"):
        gathered = out_buf[torch.where(keep, slot, torch.full_like(slot, E * C - 1))]
        gathered = gathered * keep[:, None].to(cd) * w[:, None]
        # the reference's scatter-add over tokens ``y.at[tok].add``: a sum
        # over each token's k rows, with a fixed order on every device
        y = gathered.reshape(N, k, d).sum(dim=1)

    if cfg.num_shared_experts > 0:
        with span("moe/experts"):
            y = y + mlp(params["shared"], xt, cfg.mlp_act, cd)
    return y.reshape(B, S, d), aux

