"""The reference's first COVAP cycle of a cell, from the seed: the
weights of ``bench.weights``, the batches of :mod:`.data`, the loss and
gradients of the configuration's reference module (``bench.reference.of``),
the exchange and AdamW of :mod:`.covap`.

:func:`run` returns what the comparison reads: each step's loss, and per
leaf the norm of the first step's raw gradient (before the exchange), the
norm of the first gradient the optimizer gets for each element over the
cycle (each bucket's first send, its error feedback built up over the
steps before it; read from AdamW's first moment, ``m / (1 - b1)``, at its
first non-zero value), that gradient's random projections
(``bench.sketch``), and the norm of the parameters' change over the cycle.
``mm="fp8"`` computes every matrix product from float8 (e4m3) operands
with one scale a tensor, forward and backward: the control.
"""
from __future__ import annotations

import torch

from ..sketch import project
from ..weights import fill_leaf, make_leaves
from . import covap, of
from .data import Batches

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(t.abs().amax() / E4M3_MAX, min=1e-12)
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _FP8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        qx, qw = _fp8(x), _fp8(w)
        ctx.save_for_backward(qx, qw)
        return qx @ qw

    @staticmethod
    def backward(ctx, gy):
        qx, qw = ctx.saved_tensors
        qg = _fp8(gy)
        gx = qg @ qw.mT
        gw = qx.reshape(-1, qx.shape[-1]).mT @ qg.reshape(-1, qg.shape[-1])
        return gx, gw


def fp8_matmul(x, w):
    return _FP8MatMul.apply(x, w)


MATMULS = {"f32": torch.matmul, "fp8": fp8_matmul}
# what the reference models: COVAP's exchange, whichever overlap, sync and
# arena run it (the program's are equal bit for bit)
MODELLED = {"compressor": ("covap",), "overlap": ("post", "fused"),
            "sync": ("allreduce", "sharded"), "arena": (False, True)}


def cycle(traffic: dict) -> int:
    """The steps of one COVAP cycle: every bucket is exchanged once."""
    return max(traffic["interval"], 1)


def first_sent(first: list[torch.Tensor], m: list[torch.Tensor], b1: float) -> None:
    """Where ``first`` is still zero, the gradient AdamW's first moment
    ``m`` holds after a step (``m / (1 - b1)`` when every earlier gradient
    of the element was zero)."""
    for f, mi in zip(first, m):
        f.copy_(torch.where(f == 0, mi.float() / (1 - b1), f))


def run(conf: dict, traffic: dict, *, seed: int, workers: int, device,
        steps: int | None = None, mm: str = "f32") -> dict:
    """The reference's ``steps`` steps (a COVAP cycle by default) of a cell
    on ``workers`` workers.  ``conf`` is the configuration's file,
    ``traffic`` the traffic mix's; a mix the reference does not model is
    refused."""
    for key, known in MODELLED.items():
        if traffic[key] not in known:
            raise ValueError(f"the reference does not model {key}={traffic[key]!r}")
    steps = cycle(traffic) if steps is None else steps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = of(conf)
    rule = getattr(ref, "std_of", None)
    a = ref.Arch.from_config(conf)
    shapes = ref.param_shapes(a)
    paths = list(shapes)
    params = make_leaves(shapes, seed, device, rule)
    leaves = list(params.values())
    rows, seq_len = traffic["rows_per_chip"], traffic["seq_len"]
    interval = traffic["interval"]
    data = Batches(seed, conf["vocab_size"], seq_len, rows, workers)
    buckets = covap.plan_buckets([shapes[p] for p in paths],
                                 bucket_bytes=traffic["bucket_bytes"],
                                 max_buckets=traffic["max_buckets"], interval=interval)
    o = conf["optimizer"]
    opt = covap.AdamW(leaves, o["lr"], o["b1"], o["b2"], o["eps"], o["weight_decay"])
    residuals = [[torch.zeros_like(p) for p in leaves] for _ in range(workers)]
    matmul = MATMULS[mm]
    losses, dropped = [], 0
    grad_raw = None
    first = [torch.zeros_like(p) for p in leaves]
    for step in range(steps):
        grads, total = [], 0.0
        for w in range(workers):
            tokens, labels = (torch.from_numpy(x).to(device) for x in data.batch(step, w))
            for p in leaves:
                p.requires_grad_(True)
            tot, _, _, drop = ref.loss(params, tokens, labels, a, matmul)
            g = torch.autograd.grad(tot, leaves)
            for p in leaves:
                p.requires_grad_(False)
            grads.append([x.detach() for x in g])
            total += float(tot.detach())
            dropped += drop
            del tot, g
        losses.append(total / workers)
        if step == 0:
            grad_raw = [float(torch.linalg.vector_norm(sum(gs) / workers))
                        for gs in zip(*grads)]
        synced = covap.exchange(buckets, grads, residuals, step, interval)
        del grads
        opt.step(leaves, synced)
        del synced
        first_sent(first, opt.m, o["b1"])
    del residuals, opt
    grad_first = [float(torch.linalg.vector_norm(g)) for g in first]
    sketches = [project(g, seed, i) for i, g in enumerate(first)]
    del first
    change = []
    for i, (path, p) in enumerate(params.items()):
        p0 = fill_leaf(torch.empty_like(p), seed, i, path, rule)
        change.append(float(torch.linalg.vector_norm(p - p0)))
        del p0
    return {"paths": paths, "loss": losses, "grad_raw": grad_raw, "grad": grad_first,
            "sketch": sketches, "change": change, "dropped": dropped}
