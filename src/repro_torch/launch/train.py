"""End-to-end training driver of the port (one worker).

    python -m repro_torch.launch.train --arch gpt2-paper --reduced \
        --interval 4 --steps 20 --seq-len 128 --global-batch 8 --device cpu

Prints the same ``[plan]``, ``[schedule]``, ``[model]``, per-step loss and
``[done]`` lines as ``repro.launch.train``.  ``--compressor`` picks covap,
none, fp16, fp8wire, efsignsgd or powersgd (rank 2; like the reference's
CLI this one has no rank flag), ``--arena`` the zero-copy arena and
``--sync sharded`` the reduce-scatter + deferred all-gather decomposition.  Runs on the GPU unless
``--device cpu`` is given.  ``--interval auto`` is not ported and raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_reduced
from ..data import DataConfig, make_loader
from ..models import build_model
from ..optim import adamw, cosine_warmup, sgd
from ..train.trainer import TrainConfig, Trainer


def parse_interval(value: str) -> int:
    if value == "auto":
        raise NotImplementedError(
            "--interval auto needs the analytic CCR, which is not ported; "
            "pass an integer"
        )
    return int(value)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-paper")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test REDUCED variant")
    ap.add_argument("--compressor", default="covap",
                    choices=["covap", "none", "fp16", "fp8wire", "efsignsgd",
                             "powersgd"])
    ap.add_argument("--interval", default="4")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--lr", type=float, default=1.5e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--arena", action="store_true",
                    help="zero-copy gradient arena: statically planned flat "
                         "bucket buffers + fused pack/EF/cast pass")
    ap.add_argument("--sync", default="allreduce",
                    choices=["allreduce", "sharded"],
                    help="collective decomposition: all-reduce per bucket "
                         "(default) or reduce-scatter + deferred param "
                         "all-gather at the next step's head")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    interval = parse_interval(args.interval)
    model = build_model(cfg, device=args.device, seed=args.seed)
    if args.optimizer == "adam":
        opt = adamw(cosine_warmup(args.lr, args.steps // 10 + 1, args.steps))
    else:
        opt = sgd(args.lr, momentum=0.9)

    tc = TrainConfig(compressor=args.compressor, interval=interval,
                     log_every=args.log_every, steps=args.steps,
                     arena=args.arena, sync=args.sync)
    tr = Trainer(model, opt, tc)
    print(f"[plan] {tr.plan.num_buckets} buckets, "
          f"target {tr.plan.bucket_bytes_target/1e6:.1f} MB, "
          f"{tr.num_phases} phase executable(s)")
    sr = tr.schedule_report()
    print(f"[schedule] mean {sr['mean_bytes_per_step']/1e6:.3f} MB/step "
          f"per worker (dense {sr['dense_bytes']/1e6:.3f} MB, "
          f"volume ratio {sr['volume_ratio']:.2f}x) — static plan, no tracing")
    if args.sync == "sharded":
        # the gathers start at the step's head, one per bucket, and the
        # forward pass waits for each where it first reads it: before the
        # embedding, before layer i (ParamGather.before_layer), or before
        # the final norm and head
        print(f"[schedule] sharded: "
              f"{sr['mean_exposed_wire_bytes_per_step']/1e6:.3f} MB/step "
              f"exposed wire (RS), "
              f"{sr['mean_deferred_bytes_per_step']/1e6:.3f} MB/step "
              f"deferred param AG riding the next forward pass")

    state = tr.init_state()
    n_params = sum(p.numel() for p in state["params"])
    print(f"[model] {cfg.name}: {n_params/1e6:.1f}M params")

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.global_batch)
    loader = make_loader(dc, device=args.device)
    t0 = time.perf_counter()
    tr.run(state, loader, steps=args.steps)
    if model.embed["table"].is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = args.steps * args.global_batch * args.seq_len
    last = tr.history[-1]
    print(f"[done] {wall:.1f}s, {tokens/wall:.0f} tok/s, "
          f"final loss {last['loss']:.4f}")


if __name__ == "__main__":
    main()
