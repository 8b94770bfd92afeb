"""Plain float32 PyTorch of the decoder the configurations describe: the
parameters by path, and the loss of one batch.

The decoder: token embedding times ``sqrt(d_model)``; per layer an RMSNorm
(``x / rms(x) * (1 + scale)``), causal multi-head attention with rotary
positions (rotation by halves, ``rope_theta``), a residual add, a second
RMSNorm, and either a gated MLP (``act(x W_gate) * (x W_up)) W_down``,
``gelu`` (tanh form) or ``silu``) or a mixture of experts, and a residual
add; a final RMSNorm; an untied output head over the vocabulary padded to a
multiple of 128; the mean cross-entropy of the next token.

The mixture of experts: an f32 router, softmax over the experts, the top
``k`` renormalised; each expert takes at most ``C = ceil(N k / E * cf)``
assignments, counted token by token in token order (within a token, the
more probable expert first), and drops the rest; the routed experts are
``silu(x W_gate) * (x W_up)) W_down``, weighted by the renormalised
probabilities; the shared experts are one gated MLP of width
``d_ff * num_shared_experts``; the load-balance loss is
``coef * E * sum(mean(probs) * mean(one_hot(first choice)))``.

Every matrix product goes through ``mm`` (``torch.matmul`` by default), so
that the control can compute them in a lower precision.  :func:`step_flops`
is the frozen FLOPs count of a training step.  Nothing here imports the
system under test.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

FIELDS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
          "d_ff", "vocab_size", "num_experts", "num_shared_experts",
          "experts_per_token", "moe_capacity_factor", "aux_loss_coef", "rope_theta",
          "norm_eps", "mlp_act")


@dataclasses.dataclass(frozen=True)
class Arch:
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    mlp_act: str = "swiglu"

    @classmethod
    def from_config(cls, conf: dict) -> "Arch":
        """The fields this reference reads, from a configuration file's
        object; a configuration it does not describe raises."""
        if conf.get("family") not in ("dense", "moe"):
            raise NotImplementedError(f"the reference has no {conf.get('family')!r} family")
        for key in ("qkv_bias", "logit_softcap", "attn_softcap", "sliding_window",
                    "local_global"):
            if conf.get(key):
                raise NotImplementedError(f"the reference does not take {key}")
        kw = {k: conf[k] for k in FIELDS if k in conf}
        if not kw.get("head_dim"):
            kw["head_dim"] = kw["d_model"] // kw["num_heads"]
        return cls(**kw)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def padded_vocab(self) -> int:
        return padded_vocab(self.vocab_size)


def padded_vocab(vocab: int) -> int:
    return int(math.ceil(vocab / 128) * 128)


def param_shapes(a: Arch) -> dict[str, tuple[int, ...]]:
    """Every parameter's shape by dotted path, in leaf order (paths sorted
    part by part); the layer leaves carry a leading ``num_layers`` axis."""
    n, d, f = a.num_layers, a.d_model, a.d_ff
    H, K, hd = a.num_heads, a.num_kv_heads, a.head_dim
    V = a.padded_vocab
    block = {"attn.wq": (d, H * hd), "attn.wk": (d, K * hd), "attn.wv": (d, K * hd),
             "attn.wo": (H * hd, d), "ln1.scale": (d,), "ln2.scale": (d,)}
    if a.is_moe:
        E = a.num_experts
        block.update({"moe.router": (d, E), "moe.w_gate": (E, d, f),
                      "moe.w_up": (E, d, f), "moe.w_down": (E, f, d)})
        if a.num_shared_experts:
            fs = f * a.num_shared_experts
            block.update({"moe.shared.w_gate": (d, fs), "moe.shared.w_up": (d, fs),
                          "moe.shared.w_down": (fs, d)})
    else:
        block.update({"mlp.w_gate": (d, f), "mlp.w_up": (d, f), "mlp.w_down": (f, d)})
    shapes = {"embed.table": (V, d), "head.w": (d, V), "stack.final_norm.scale": (d,)}
    shapes.update({f"stack.blocks.b0.{k}": (n,) + s for k, s in block.items()})
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


def attention(p, x, a: Arch, mm):
    B, S, _ = x.shape
    H, K, hd = a.num_heads, a.num_kv_heads, a.head_dim
    q = mm(x, p["attn.wq"]).reshape(B, S, H, hd)
    k = mm(x, p["attn.wk"]).reshape(B, S, K, hd)
    v = mm(x, p["attn.wv"]).reshape(B, S, K, hd)
    q, k = rope(q, a.rope_theta), rope(k, a.rope_theta)
    G = H // K
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bthd->bhqt", q, k) * hd ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqt,bthd->bqhd", torch.softmax(s, dim=-1), v)
    return mm(o.reshape(B, S, H * hd), p["attn.wo"])


def _act(name, x):
    if name == "swiglu":
        return F.silu(x)
    if name in ("gelu", "geglu"):
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def mlp(w_gate, w_up, w_down, x, act, mm):
    return mm(_act(act, mm(x, w_gate)) * mm(x, w_up), w_down)


def capacity(a: Arch, n_tokens: int) -> int:
    return int(math.ceil(n_tokens * a.experts_per_token / a.num_experts
                         * a.moe_capacity_factor))


def moe(p, x, a: Arch, mm):
    """-> (y, aux, dropped assignments)."""
    B, S, d = x.shape
    E, k = a.num_experts, a.experts_per_token
    xt = x.reshape(-1, d)
    N = xt.shape[0]
    probs = torch.softmax(xt @ p["moe.router"], dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / (top_p.sum(dim=-1, keepdim=True) + 1e-9)
    first = F.one_hot(top_e[:, 0], E).float()
    aux = a.aux_loss_coef * E * torch.sum(probs.mean(dim=0) * first.mean(dim=0))
    C = capacity(a, N)
    eid = top_e.reshape(-1)                                  # token-major
    pos = torch.cumsum(F.one_hot(eid, E), dim=0).gather(1, eid[:, None])[:, 0] - 1
    keep = pos < C
    tok = torch.arange(N, device=x.device).repeat_interleave(k)
    weight = top_p.reshape(-1)
    y = torch.zeros_like(xt)
    for e in range(E):
        idx = torch.nonzero((eid == e) & keep)[:, 0]
        if idx.numel() == 0:
            continue
        h = mlp(p["moe.w_gate"][e], p["moe.w_up"][e], p["moe.w_down"][e],
                xt[tok[idx]], "swiglu", mm)
        y = y.index_add(0, tok[idx], h * weight[idx, None])
    if a.num_shared_experts:
        y = y + mlp(p["moe.shared.w_gate"], p["moe.shared.w_up"], p["moe.shared.w_down"],
                    xt, a.mlp_act, mm)
    return y.reshape(B, S, d), aux, int((~keep).sum())


def loss(params: dict[str, torch.Tensor], tokens, labels, a: Arch, mm=torch.matmul):
    """-> (total loss, cross-entropy, aux loss, dropped assignments) of one
    batch; ``params`` by path, ``tokens``/``labels`` (B, S) int64."""
    x = params["embed.table"][tokens] * math.sqrt(a.d_model)
    aux = x.new_zeros(())
    dropped = 0
    blocks = {k.removeprefix("stack.blocks.b0."): v for k, v in params.items()
              if k.startswith("stack.blocks.b0.")}
    for i in range(a.num_layers):
        p = {k: v[i] for k, v in blocks.items()}
        h = rmsnorm(x, p["ln1.scale"], a.norm_eps)
        x = x + attention(p, h, a, mm)
        h = rmsnorm(x, p["ln2.scale"], a.norm_eps)
        if a.is_moe:
            y, aux_i, drop_i = moe(p, h, a, mm)
            aux, dropped = aux + aux_i, dropped + drop_i
        else:
            y = mlp(p["mlp.w_gate"], p["mlp.w_up"], p["mlp.w_down"], h, a.mlp_act, mm)
        x = x + y
    x = rmsnorm(x, params["stack.final_norm.scale"], a.norm_eps)
    B, S, d = x.shape
    xent = x.new_zeros(())
    for r in range(B):       # one row of logits at a time
        logits = mm(x[r], params["head.w"])
        xent = xent + F.cross_entropy(logits, labels[r], reduction="sum")
    xent = xent / (B * S)
    return xent + aux, xent, aux, dropped


def step_flops(conf: dict, *, rows: int, seq_len: int) -> float:
    """The global FLOPs of one training step over ``rows`` rows (every
    worker's) of ``seq_len`` tokens, in closed form from the configuration:
    a multiply-add is 2 FLOPs; the backward pass is twice the forward;
    attention counts the causal half of its scores and values; a mixture of
    experts counts the router and the active experts only (``k`` routed plus
    the shared ones), not the capacity's padding; the embedding's gather is
    free; nothing recomputed for memory counts."""
    B, S = rows, seq_len
    d = conf["d_model"]
    H, K = conf["num_heads"], conf["num_kv_heads"]
    hd = conf.get("head_dim") or d // H
    proj = 2.0 * B * S * d * (2 * H * hd + 2 * K * hd)
    attn = 2.0 * 2.0 * B * S * H * hd * (S / 2.0)
    if conf.get("num_experts", 0) > 0:
        active = conf["experts_per_token"] + conf.get("num_shared_experts", 0)
        ffn = 2.0 * B * S * (d * conf["num_experts"] + active * 3 * d * conf["d_ff"])
    else:
        ffn = 2.0 * B * S * 3 * d * conf["d_ff"]
    head = 2.0 * B * S * d * padded_vocab(conf["vocab_size"])
    return 3.0 * (conf["num_layers"] * (proj + attn + ffn) + head)
