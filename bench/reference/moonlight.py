"""Plain float32 PyTorch of the DeepSeek-V3 decoder that Moonlight-16B-A3B
publishes: the parameters by path, and the loss of one batch, computed in
blocks so that one card holds it beside the first cycle's state.

The decoder: token embedding times ``sqrt(d_model)``; ``first_k_dense_replace``
dense layers, then MoE layers; each layer an RMSNorm (``x / rms(x) * (1 +
scale)``), multi-head latent attention, a residual add, a second RMSNorm,
a gated MLP (dense layers, width ``intermediate_size``) or the mixture of
experts, a residual add; a final RMSNorm; an untied output head over the
vocabulary padded to a multiple of 128; the mean cross-entropy of the next
token.

Latent attention (no query latent): ``q = x W_q``, per head ``[q_nope |
q_rope]``; ``[c | k_r] = x W_kva``; ``[k_nope | v] = RMSNorm(c) W_kvb`` per
head (the latent's norm at eps 1e-6, DeepSeek's default for it); rotary
positions (rotation by halves, ``rope_theta``) on ``q_rope`` and on
``k_r``, which every head shares; causal softmax of ``q . [k_nope | k_r]``
at scale ``(nope + rope) ** -0.5``; the heads' values joined and
projected by ``W_o``.

The mixture of experts: an f32 router ``s = sigmoid(x W_r)`` over all
``n_routed_experts``; the top ``k`` of ``s``, weighted ``s_e / sum(top-k
s) * routed_scaling_factor``; each expert takes at most ``C = ceil(N k / E
* cf)`` assignments, counted token by token in token order (within a
token, the higher score first), and drops the rest; the layer holds
``num_experts`` experts from ``first_expert`` on and computes only their
assignments (a chip's share under expert parallelism); the routed experts
are ``(silu(x W_gate) * (x W_up)) W_down``; the shared experts one gated
MLP of width ``d_ff * num_shared_experts``, added whole; the load-balance
loss the sequence-wise one, ``coef * sum_i f_i P_i`` averaged over the
rows, ``P_i`` a row's mean of ``s_i / sum_j s_j``, ``f_i`` the row's
choices of ``i`` times ``E / (k T)``.

Every matrix product goes through ``mm`` (``torch.matmul`` by default),
except the router's, which stays float32 as the system's does, so that the
control changes precision and not the routing.  The blocks: each layer is
checkpointed, attention runs by query blocks of :data:`Q_BLOCK` (each
checkpointed, over the keys up to its last query), the cross-entropy by
chunks of :data:`XENT_CHUNK` tokens.  :func:`step_flops` is the frozen
FLOPs count of a training step.  Nothing here imports the system under
test.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FIELDS = ("num_layers", "d_model", "num_heads", "d_ff", "vocab_size", "num_experts",
          "n_routed_experts", "first_expert", "num_shared_experts", "experts_per_token",
          "moe_capacity_factor", "aux_loss_coef", "rope_theta", "norm_eps", "kv_lora_rank",
          "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "first_k_dense_replace",
          "intermediate_size", "routed_scaling_factor")
LATENT_NORM_EPS = 1e-6
Q_BLOCK = 1024
XENT_CHUNK = 1024


@dataclasses.dataclass(frozen=True)
class Arch:
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_experts: int
    n_routed_experts: int
    first_expert: int
    num_shared_experts: int
    experts_per_token: int
    moe_capacity_factor: float
    aux_loss_coef: float
    rope_theta: float
    norm_eps: float
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    first_k_dense_replace: int
    intermediate_size: int
    routed_scaling_factor: float

    @classmethod
    def from_config(cls, conf: dict) -> "Arch":
        """The fields this reference reads, from a configuration file's
        object; a configuration it does not describe raises."""
        want = {"family": "moe", "scoring_func": "sigmoid", "mlp_act": "swiglu"}
        for key, value in want.items():
            if conf.get(key) != value:
                raise NotImplementedError(f"the reference takes only {key}={value!r}")
        if not conf.get("norm_topk_prob", True):
            raise NotImplementedError("the reference takes only norm_topk_prob=True")
        if not conf.get("kv_lora_rank") or conf.get("q_lora_rank"):
            raise NotImplementedError("the reference is latent attention without a query latent")
        for key in ("qkv_bias", "logit_softcap", "attn_softcap", "sliding_window",
                    "local_global"):
            if conf.get(key):
                raise NotImplementedError(f"the reference does not take {key}")
        kw = {k: conf[k] for k in FIELDS if k in conf}
        kw["n_routed_experts"] = kw.get("n_routed_experts") or kw["num_experts"]
        kw.setdefault("first_expert", 0)
        return cls(**kw)

    @property
    def padded_vocab(self) -> int:
        return int(math.ceil(self.vocab_size / 128) * 128)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def _attn_shapes(a: Arch) -> dict[str, tuple[int, ...]]:
    d, H, r = a.d_model, a.num_heads, a.kv_lora_rank
    return {"attn.wq": (d, H * a.qk_head_dim),
            "attn.wkv_a": (d, r + a.qk_rope_head_dim),
            "attn.kv_norm.scale": (r,),
            "attn.wkv_b": (r, H * (a.qk_nope_head_dim + a.v_head_dim)),
            "attn.wo": (H * a.v_head_dim, d),
            "ln1.scale": (d,), "ln2.scale": (d,)}


def param_shapes(a: Arch) -> dict[str, tuple[int, ...]]:
    """Every parameter's shape by dotted path, in leaf order (paths sorted
    part by part); the dense layers' leaves carry a leading
    ``first_k_dense_replace`` axis, the MoE layers' a leading axis of the
    rest."""
    d, f, E = a.d_model, a.d_ff, a.num_experts
    k, n = a.first_k_dense_replace, a.num_layers - a.first_k_dense_replace
    fd, fs = a.intermediate_size, a.d_ff * a.num_shared_experts
    dense = dict(_attn_shapes(a), **{"mlp.w_gate": (d, fd), "mlp.w_up": (d, fd),
                                     "mlp.w_down": (fd, d)})
    block = dict(_attn_shapes(a), **{
        "moe.router": (d, a.n_routed_experts), "moe.w_gate": (E, d, f),
        "moe.w_up": (E, d, f), "moe.w_down": (E, f, d)})
    if a.num_shared_experts:
        block.update({"moe.shared.w_gate": (d, fs), "moe.shared.w_up": (d, fs),
                      "moe.shared.w_down": (fs, d)})
    V = a.padded_vocab
    shapes = {"embed.table": (V, d), "head.w": (d, V), "stack.final_norm.scale": (d,)}
    shapes.update({f"stack.blocks.b0.{p}": (n,) + s for p, s in block.items()})
    if k:
        shapes.update({f"stack.dense.{p}": (k,) + s for p, s in dense.items()})
    return dict(sorted(shapes.items(), key=lambda kv: kv[0].split(".")))


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x, theta):
    """x: (B, S, H, hd), rotated by halves at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=x.device)
                      * (math.log(theta) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(q, k, v, lo):
    """Queries ``lo ..`` (q: B, Sq, H, hq) over keys ``0 ..`` up to the
    last of them (k: B, T, H, hq; v: B, T, H, hv), causal."""
    Sq, T = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bthd->bhqt", q, k) * q.shape[-1] ** -0.5
    causal = (torch.arange(T, device=q.device)[None, :]
              <= lo + torch.arange(Sq, device=q.device)[:, None])
    s = s.masked_fill(~causal, float("-inf"))
    return torch.einsum("bhqt,bthd->bqhd", torch.softmax(s, dim=-1), v)


def attention(p, x, a: Arch, mm):
    B, S, _ = x.shape
    H, r, nope = a.num_heads, a.kv_lora_rank, a.qk_nope_head_dim
    q = mm(x, p["attn.wq"]).reshape(B, S, H, a.qk_head_dim)
    kv_a = mm(x, p["attn.wkv_a"])
    c = rmsnorm(kv_a[..., :r], p["attn.kv_norm.scale"], LATENT_NORM_EPS)
    kv = mm(c, p["attn.wkv_b"]).reshape(B, S, H, nope + a.v_head_dim)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], a.rope_theta)], dim=-1)
    k_r = rope(kv_a[..., None, r:], a.rope_theta).expand(B, S, H, a.qk_rope_head_dim)
    k = torch.cat([kv[..., :nope], k_r], dim=-1)
    v = kv[..., nope:]
    outs = []
    for lo in range(0, S, Q_BLOCK):
        hi = min(lo + Q_BLOCK, S)
        outs.append(checkpoint(_attend_block, q[:, lo:hi], k[:, :hi], v[:, :hi], lo,
                               use_reentrant=False))
    o = torch.cat(outs, dim=1)
    return mm(o.reshape(B, S, H * a.v_head_dim), p["attn.wo"])


def mlp(w_gate, w_up, w_down, x, mm):
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def capacity(a: Arch, n_tokens: int) -> int:
    return int(math.ceil(n_tokens * a.experts_per_token / a.n_routed_experts
                         * a.moe_capacity_factor))


def moe(p, x, a: Arch, mm):
    """-> (y, aux, dropped assignments of the held experts)."""
    B, S, d = x.shape
    E, k = a.n_routed_experts, a.experts_per_token
    xt = x.reshape(-1, d)
    N = xt.shape[0]
    s = torch.sigmoid(xt @ p["moe.router"])
    top_s, top_e = torch.topk(s, k, dim=-1)
    top_s = top_s / (top_s.sum(dim=-1, keepdim=True) + 1e-20)
    weight = (top_s * a.routed_scaling_factor).reshape(-1)
    chosen = F.one_hot(top_e, E).float().reshape(B, S * k, E).sum(dim=1)
    share = (s / s.sum(dim=-1, keepdim=True)).reshape(B, S, E).mean(dim=1)
    aux = a.aux_loss_coef * torch.mean(torch.sum(chosen * (E / (k * S)) * share, dim=-1))
    C = capacity(a, N)
    eid = top_e.reshape(-1)                                  # token-major
    pos = torch.cumsum(F.one_hot(eid, E), dim=0).gather(1, eid[:, None])[:, 0] - 1
    keep = pos < C
    tok = torch.arange(N, device=x.device).repeat_interleave(k)
    held = range(a.first_expert, a.first_expert + a.num_experts)
    y = torch.zeros_like(xt)
    for e in held:
        idx = torch.nonzero((eid == e) & keep)[:, 0]
        if idx.numel() == 0:
            continue
        j = e - a.first_expert
        h = mlp(p["moe.w_gate"][j], p["moe.w_up"][j], p["moe.w_down"][j], xt[tok[idx]], mm)
        y = y.index_add(0, tok[idx], h * weight[idx, None])
    if a.num_shared_experts:
        y = y + mlp(p["moe.shared.w_gate"], p["moe.shared.w_up"], p["moe.shared.w_down"],
                    xt, mm)
    mine = (eid >= held.start) & (eid < held.stop)
    return y.reshape(B, S, d), aux, int((mine & ~keep).sum())


def _layer(x, p, a: Arch, mm, is_moe: bool):
    """One layer -> (x, aux, dropped)."""
    h = rmsnorm(x, p["ln1.scale"], a.norm_eps)
    x = x + attention(p, h, a, mm)
    h = rmsnorm(x, p["ln2.scale"], a.norm_eps)
    if is_moe:
        y, aux, dropped = moe(p, h, a, mm)
    else:
        y = mlp(p["mlp.w_gate"], p["mlp.w_up"], p["mlp.w_down"], h, mm)
        aux, dropped = x.new_zeros(()), 0
    return x + y, aux, dropped


def _xent_sum(x, head, labels, mm):
    return F.cross_entropy(mm(x, head), labels, reduction="sum")


def loss(params: dict[str, torch.Tensor], tokens, labels, a: Arch, mm=torch.matmul):
    """-> (total loss, cross-entropy, aux loss, dropped assignments) of one
    batch; ``params`` by path, ``tokens``/``labels`` (B, S) int64."""
    x = params["embed.table"][tokens] * math.sqrt(a.d_model)
    aux = x.new_zeros(())
    dropped = 0
    k = a.first_k_dense_replace
    stacks = [("stack.dense.", False, k), ("stack.blocks.b0.", True, a.num_layers - k)]
    for prefix, is_moe, rows in stacks:
        leaves = {n.removeprefix(prefix): v for n, v in params.items() if n.startswith(prefix)}
        for i in range(rows):
            p = {n: v[i] for n, v in leaves.items()}
            x, aux_i, drop_i = checkpoint(_layer, x, p, a, mm, is_moe, use_reentrant=False)
            aux, dropped = aux + aux_i, dropped + drop_i
    x = rmsnorm(x, params["stack.final_norm.scale"], a.norm_eps)
    B, S, d = x.shape
    xent = x.new_zeros(())
    for r in range(B):
        for lo in range(0, S, XENT_CHUNK):
            hi = min(lo + XENT_CHUNK, S)
            xent = xent + checkpoint(_xent_sum, x[r, lo:hi], params["head.w"],
                                     labels[r, lo:hi], mm, use_reentrant=False)
    xent = xent / (B * S)
    return xent + aux, xent, aux, dropped


def step_flops(conf: dict, *, rows: int, seq_len: int) -> float:
    """The global FLOPs of one training step over ``rows`` rows (every
    worker's) of ``seq_len`` tokens, in closed form from the configuration:
    a multiply-add is 2 FLOPs; the backward pass is twice the forward;
    attention counts its four projections and the causal half of its
    scores (at the query/key width) and values (at the value width); an
    MoE layer counts the router, the shared experts and the held routed
    experts at their expected load, ``k`` of the router's ``E`` a token
    times ``num_experts / E`` held (not the capacity's padding); the dense
    layers their MLP; the embedding's gather is free; norms, rotary
    positions and anything recomputed for memory do not count."""
    a = Arch.from_config(conf)
    B, S, d, H = rows, seq_len, a.d_model, a.num_heads
    r, rd, vd = a.kv_lora_rank, a.qk_rope_head_dim, a.v_head_dim
    qk = a.qk_head_dim
    proj = 2.0 * B * S * (d * H * qk + d * (r + rd) + r * H * (qk - rd + vd) + H * vd * d)
    attn = 2.0 * B * S * H * (qk + vd) * (S / 2.0)
    E = a.n_routed_experts
    active = a.experts_per_token * a.num_experts / E + a.num_shared_experts
    ffn_moe = 2.0 * B * S * (d * E + active * 3 * d * a.d_ff)
    ffn_dense = 2.0 * B * S * 3 * d * a.intermediate_size
    k = a.first_k_dense_replace
    head = 2.0 * B * S * d * a.padded_vocab
    return 3.0 * ((a.num_layers - k) * (proj + attn + ffn_moe)
                  + k * (proj + attn + ffn_dense) + head)
