"""Mixture-of-Experts FFN: top-k router and shared experts (DeepSeekMoE's
fine-grained experts; also Grok-1's 8 experts, top-2) — the counterpart of
``repro.models.moe``, with its semantics kept exactly.

Dispatch is capacity-based gather/scatter with static shapes:

    tokens -> f32 router, softmax, top-k, renormalised ->
    position-in-expert from a cumsum over the token-major (N*k) order ->
    scatter into (E, C, d) buffers -> batched expert matmuls ->
    gather back, weighted by the router probabilities.

That is the plain path, which CPU tensors take (``dispatch``,
``permute_plain``, ``unpermute_plain``).  CUDA tensors take the kernels of
``kernels/moe_dispatch.py``: one slot map gives each assignment its slot
and each slot its assignment (``slot_sources`` is its plain inverse), and
rows move by gathers with unique destinations, forward and backward.

An assignment past capacity ``C = ceil(N*k/E * capacity_factor)`` (over
this worker's ``N`` tokens) is dropped: earlier tokens, and within a token
the higher-probability choice, win a full expert; while a profiler
records, the counters ``moe/assigned`` and ``moe/dropped`` (``obs.spans``)
add up the assignments and the dropped ones.  The Switch-style aux
loss uses ``mean(probs)`` and the first choice's one-hot.  The routed
experts use ``silu(g) * u`` whatever ``mlp_act`` is; the shared experts
are one ``mlp(..., cfg.mlp_act)`` of width ``d_ff * num_shared_experts``.

DeepSeek-V3's router (``scoring_func="sigmoid"``; the port's, not the
reference's): ``s = sigmoid(x W_r)`` in f32, the top ``k`` of ``s``,
each weighted by ``s_e`` over the top-k's sum (always: ``norm_topk_prob``
true) times ``routed_scaling_factor``; its aux loss is the sequence-wise one,
``coef * sum_i f_i P_i`` averaged over the rows, ``P_i`` the row's mean of
``s_i / sum_j s_j`` and ``f_i`` the row's choices of ``i`` times ``E/(k T)``.
The correction bias of ``noaux_tc`` is not modelled (it would be zero at
the first step).

An expert share (expert parallelism's layer, one chip's part): the layer
holds ``num_experts`` experts from ``first_expert`` on, of the
``n_routed_experts`` the router scores.  It routes over all of them, sizes
``C`` by them, and dispatches and computes only the assignments to its
own; the shared experts are added whole.  What the absent experts would
add is left out: the shares' outputs, less the shared experts counted
once, add up to the whole layer's.  While a profiler records,
``moe/held`` counts the assignments to the held experts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.moe_dispatch import moe_dispatch, permute, unpermute
from ..obs.spans import count, recording, span
from .layers import mlp


def moe_param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Shapes of one block's ``moe`` leaves, keyed by their path under it:
    the router over every routed expert, the held experts' weights."""
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    shapes = {
        "router": (d, cfg.routed_experts),
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
    return int(math.ceil(n_tokens * cfg.experts_per_token / cfg.routed_experts
                         * cfg.moe_capacity_factor))


def is_share(cfg) -> bool:
    """Whether the layer holds only some of the routed experts."""
    return cfg.num_experts < cfg.routed_experts


def _route_sigmoid(logits, cfg, rows: int):
    E, k = cfg.routed_experts, cfg.experts_per_token
    scores = torch.sigmoid(logits)
    top_s, top_e = torch.topk(scores, k, dim=-1)
    top_s = top_s / (torch.sum(top_s, dim=-1, keepdim=True) + 1e-20)
    top_p = top_s * cfg.routed_scaling_factor
    T = logits.shape[0] // rows
    share = (scores / torch.sum(scores, dim=-1, keepdim=True)).reshape(rows, T, E)
    chosen = torch.zeros((rows, E), dtype=torch.float32, device=logits.device)
    chosen.scatter_add_(1, top_e.reshape(rows, T * k),
                        torch.ones((rows, T * k), dtype=torch.float32, device=logits.device))
    f = chosen * (E / (k * T))
    aux = cfg.aux_loss_coef * torch.mean(torch.sum(f * torch.mean(share, dim=1), dim=-1))
    return scores, top_p, top_e, aux


def route(params, xt: torch.Tensor, cfg, rows: int = 1):
    """The f32 router over tokens ``xt`` (N, d), ``rows`` rows of tokens ->
    ``(probs (N, E), top_p (N, k) renormalised, top_e (N, k), aux)``; for
    the sigmoid router ``probs`` are the scores and ``top_p`` the weights."""
    E, k = cfg.routed_experts, cfg.experts_per_token
    logits = xt.float() @ params["router"].float()
    if cfg.scoring_func == "sigmoid":
        return _route_sigmoid(logits, cfg, rows)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / (torch.sum(top_p, dim=-1, keepdim=True) + 1e-9)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(top_e[:, 0], E).float(), dim=0)
    aux = cfg.aux_loss_coef * E * torch.sum(me * ce)
    return probs, top_p, top_e, aux


def held(top_e: torch.Tensor, cfg) -> torch.Tensor:
    """Which of the assignments ``top_e`` go to the experts held here."""
    e = top_e - cfg.first_expert
    return (e >= 0) & (e < cfg.num_experts)


def dispatch(top_e: torch.Tensor, cfg, C: int):
    """Each assignment's slot in the (E*C) buffer of the ``E`` held
    experts, token-major: ``(slot, keep)``, with a dropped assignment (past
    capacity, or to an expert not held) at slot ``E*C``."""
    E = cfg.num_experts
    eid = top_e.reshape(-1)
    share = is_share(cfg)
    if share:
        mine = held(eid, cfg)
        # the experts not held share one spare column, never kept
        eid = torch.where(mine, eid - cfg.first_expert, torch.full_like(eid, E))
    onehot = F.one_hot(eid, E + share)
    pos = torch.gather(torch.cumsum(onehot, dim=0) - 1, 1, eid[:, None])[:, 0]
    keep = pos < C
    if share:
        keep &= mine
    slot = torch.where(keep, eid * C + pos, torch.full_like(eid, E * C))
    return slot, keep


def slot_sources(slot: torch.Tensor, keep: torch.Tensor, n_slots: int) -> torch.Tensor:
    """The inverse of ``dispatch``'s map: ``src (n_slots,) int32``, the
    assignment that fills each slot, -1 for a slot left empty."""
    src = torch.full((n_slots,), -1, dtype=torch.int32, device=slot.device)
    src[slot[keep]] = torch.nonzero(keep)[:, 0].to(torch.int32)
    return src


def permute_plain(xt: torch.Tensor, slot: torch.Tensor, k: int, E: int,
                  C: int) -> torch.Tensor:
    """The held experts' (E, C, d) buffer of the tokens' rows ``xt`` (N, d)
    by ``dispatch``'s slots; a slot no assignment fills is zero."""
    N, d = xt.shape
    # each token's row k times, token-major (the reference's
    # ``xt[repeat(arange(N), k)]``): an expand, whose backward sums each
    # token's k rows in a fixed order, where an index's would scatter-add
    rows = xt[:, None, :].expand(N, k, d).reshape(N * k, d)
    # one spare row takes every dropped assignment; it is cut off
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=xt.device)
    return buf.index_put((slot,), rows)[:E * C].reshape(E, C, d)


def unpermute_plain(out_buf: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
                    w: torch.Tensor, k: int) -> torch.Tensor:
    """The tokens' outputs (N, d) from the experts' rows ``out_buf`` (E*C,
    d), each kept assignment's row weighted by ``w``."""
    last = out_buf.shape[0] - 1
    gathered = out_buf[torch.where(keep, slot, torch.full_like(slot, last))]
    gathered = gathered * keep[:, None].to(out_buf.dtype) * w[:, None]
    # the reference's scatter-add over tokens ``y.at[tok].add``: a sum
    # over each token's k rows, with a fixed order on every device
    return gathered.reshape(-1, k, out_buf.shape[1]).sum(dim=1)


def moe_apply(params, x: torch.Tensor, cfg):
    """x: (B, S, d) -> (y, aux_loss).  CUDA tensors dispatch and combine
    through ``kernels/moe_dispatch.py``, any other through the plain path."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    cd = getattr(torch, cfg.compute_dtype)
    N = B * S
    xt = x.reshape(N, d)
    card = x.is_cuda

    with span("moe/route"):
        _, top_p, top_e, aux = route(params, xt, cfg, B)
    with span("moe/dispatch"):
        C = capacity(cfg, N)
        if card:
            slot, keep, src = moe_dispatch(top_e, cfg.first_expert, E, C)
        else:
            slot, keep = dispatch(top_e, cfg, C)
        w = top_p.reshape(-1).to(cd)
        if recording():
            count("moe/assigned", keep.numel())
            # summed after the profiled window: no launch inside the step
            if not is_share(cfg):
                count("moe/dropped", lambda keep=keep: (~keep).sum())
            else:
                def mine(top_e=top_e):
                    return held(top_e.reshape(-1), cfg)
                count("moe/dropped", lambda keep=keep: (mine() & ~keep).sum())
                count("moe/held", lambda: mine().sum())
        buf = (permute(xt.to(cd), slot, src, k, E, C) if card
               else permute_plain(xt.to(cd), slot, k, E, C))

    with span("moe/experts"):
        g = torch.bmm(buf, params["w_gate"].to(cd))
        u = torch.bmm(buf, params["w_up"].to(cd))
        h = F.silu(g) * u
        out_buf = torch.bmm(h, params["w_down"].to(cd)).reshape(E * C, d)

    with span("moe/combine"):
        y = (unpermute(out_buf, w, slot, src, k) if card
             else unpermute_plain(out_buf, slot, keep, w, k))

    if cfg.num_shared_experts > 0:
        with span("moe/experts"):
            y = y + mlp(params["shared"], xt, cfg.mlp_act, cd)
    return y.reshape(B, S, d), aux
