"""Step time of ``overlap="post"`` against ``overlap="fused"`` on one
execution form, alternating in one process on one GPU.

    python -m repro_torch.launch.compare_overlap --form arena --pairs 12

Builds two trainers of full-width gpt2-paper from the same seed, one per
overlap, in a one-rank NCCL process group (``--no-group``: none, so no
collective runs), runs ``--warmup`` steps of each, then ``--pairs`` pairs
of one step each, alternating which side goes first, each step timed on
the host up to a device synchronise.  Prints the card and its power limit,
each side's median step ms and quartiles, and how many pairs the fused
step won.  Needs a GPU; with none it raises.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch
import torch.distributed as dist

from ..configs import get_config, get_reduced
from ..data import DataConfig, make_loader
from ..models import build_model
from ..optim import adamw, cosine_warmup
from ..train.trainer import TrainConfig, Trainer
from .mesh import free_port

FORMS = {"defaults": {}, "arena": {"arena": True}, "sharded": {"sync": "sharded"}}


def _quartiles(xs: list[float]) -> tuple[float, float, float]:
    q = statistics.quantiles(xs, n=4)
    return q[0], statistics.median(xs), q[2]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-paper")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--form", default="defaults", choices=sorted(FORMS))
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--no-group", action="store_true")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise RuntimeError("compare_overlap needs a GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.cuda.set_device(0)
    group = None
    if not args.no_group:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
        group = dist.group.WORLD
    try:
        cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
        steps = args.warmup + args.pairs
        sides = {}
        for overlap in ("post", "fused"):
            model = build_model(cfg, device="cuda", seed=0)
            tr = Trainer(model, adamw(cosine_warmup(1.5e-4, steps // 10 + 1, steps)),
                         TrainConfig(overlap=overlap, steps=steps, **FORMS[args.form]),
                         group=group)
            loader = iter(make_loader(DataConfig(vocab_size=cfg.vocab_size,
                                                 seq_len=args.seq_len,
                                                 global_batch=args.global_batch),
                                      device="cuda"))
            state = tr.run(tr.init_state(), loader, steps=args.warmup, log=None)
            sides[overlap] = [tr, state, loader, []]
        torch.cuda.synchronize()
        for i in range(args.pairs):
            order = ("post", "fused") if i % 2 == 0 else ("fused", "post")
            for overlap in order:
                side = sides[overlap]
                batch = next(side[2])
                t0 = time.perf_counter()
                side[1], _ = side[0].step(side[1], batch)
                torch.cuda.synchronize()
                side[3].append((time.perf_counter() - t0) * 1e3)
        post, fused = sides["post"][3], sides["fused"][3]
        wins = sum(f < p for p, f in zip(post, fused))
        lines = [f"[compare] {smi} | {cfg.name} {args.form}, seq {args.seq_len} x batch "
                 f"{args.global_batch}, {'no group' if group is None else 'one-rank NCCL'},"
                 f" {args.pairs} alternating pairs after {args.warmup} warm-up steps each"]
        for name, xs in (("post", post), ("fused", fused)):
            q1, med, q3 = _quartiles(xs)
            lines.append(f"[compare] {name}: median {med:.2f} ms, quartiles {q1:.2f}-{q3:.2f}"
                         f" ms, steps {[round(x, 2) for x in xs]}")
        lines.append(f"[compare] fused faster in {wins} of {args.pairs} pairs")
        print("\n".join(lines), flush=True)
    finally:
        if group is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
