"""End-to-end training driver of the port (one worker).

    python -m repro_torch.launch.train --arch gpt2-paper --reduced \
        --interval auto --steps 20 --seq-len 128 --global-batch 8 --device cpu

Prints the same ``[ccr]`` (with ``--interval auto``, the default),
``[plan]``, ``[schedule]``, ``[model]``, per-step loss and ``[done]`` lines
as ``repro.launch.train``.  ``--interval auto`` is the paper's ``I =
ceil(CCR)`` from the analytic CCR of a ``--dp-workers``-worker run on the
paper's environment (V100 + 30 Gbps Ethernet).  ``--compressor`` picks covap,
none, fp16, fp8wire, efsignsgd, powersgd (rank 2; like the reference's
CLI this one has no rank flag), or one of the sparsifiers topk, dgc,
randomk and oktopk (their default ratios; they take neither ``--overlap
fused`` nor ``--sync sharded``), ``--arena`` the zero-copy arena and
``--sync sharded`` the reduce-scatter + deferred all-gather decomposition,
``--overlap fused`` each bucket's collective started inside the backward
pass.  Runs on the GPU unless ``--device cpu`` is given.

``--ckpt-dir D --ckpt-every N`` saves the full state (params, optimizer and
EF residuals) every N steps and at the end; ``--resume`` restarts from the
latest checkpoint in D, re-planning through ``Trainer.replan`` when the
saved interval differs.  As in the reference, the resumed run's data
stream starts again from the loader's first batch.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import checkpoint
from ..api import resolve_interval
from ..configs import get_config, get_reduced
from ..data import DataConfig, make_loader
from ..models import build_model
from ..optim import adamw, cosine_warmup, sgd
from ..train.trainer import TrainConfig, Trainer


def pick_interval(args, cfg) -> int:
    """``api.resolve_interval``: ``I = ceil(analytic_ccr)`` for ``auto``,
    modelled on the paper's environment for a ``--dp-workers`` run."""
    choice = resolve_interval(
        args.interval if args.interval == "auto" else int(args.interval), cfg,
        global_batch=args.global_batch, seq_len=args.seq_len,
        dp_world=max(args.dp_workers, 1),
    )
    if choice.auto:
        print(f"[ccr] analytic CCR={choice.ccr:.2f} -> interval I={choice.interval}")
    return choice.interval


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-paper")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test REDUCED variant")
    ap.add_argument("--compressor", default="covap",
                    choices=["covap", "none", "fp16", "fp8wire", "efsignsgd",
                             "powersgd", "topk", "dgc", "randomk", "oktopk"])
    ap.add_argument("--interval", default="auto")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--dp-workers", type=int, default=8,
                    help="modelled DP world size for CCR selection")
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--lr", type=float, default=1.5e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir "
                         "(params, optimizer AND error-feedback state); the "
                         "data stream starts again from the loader's first "
                         "batch, as in the reference")
    ap.add_argument("--arena", action="store_true",
                    help="zero-copy gradient arena: statically planned flat "
                         "bucket buffers + fused pack/EF/cast pass")
    ap.add_argument("--sync", default="allreduce",
                    choices=["allreduce", "sharded"],
                    help="collective decomposition: all-reduce per bucket "
                         "(default) or reduce-scatter + deferred param "
                         "all-gather at the next step's head")
    ap.add_argument("--overlap", default="post", choices=["post", "fused"],
                    help="gradient-sync placement: after the backward pass "
                         "(default) or each bucket started inside it")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    interval = pick_interval(args, cfg)
    model = build_model(cfg, device=args.device, seed=args.seed)
    if args.optimizer == "adam":
        opt = adamw(cosine_warmup(args.lr, args.steps // 10 + 1, args.steps))
    else:
        opt = sgd(args.lr, momentum=0.9)

    tc = TrainConfig(compressor=args.compressor, interval=interval,
                     log_every=args.log_every, steps=args.steps,
                     arena=args.arena, sync=args.sync, overlap=args.overlap)
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
    if args.resume and args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
        state, extra = checkpoint.restore_train_state(args.ckpt_dir, state,
                                                      names=tr.leaf_names)
        print(f"[ckpt] resumed step {state['step']} "
              f"(EF state: {extra.get('has_comp_state')}, "
              f"saved interval: {extra.get('interval')})")
        if not extra.get("comp_restored", True):
            print("[ckpt] WARNING: saved compressor state is incompatible with "
                  "this config (EF on/off changed, or another world size "
                  f"than the saved {extra.get('world', 1)}); residual "
                  "re-initialised")
        elif extra.get("interval") not in (None, interval):
            # the residual was accumulated under another cadence: cross the
            # boundary through the runtime's transition logic
            state, rep = tr.replan(interval, state, step=state["step"],
                                   old_interval=extra["interval"])
            print(f"[ckpt] interval {extra['interval']} -> {interval}: "
                  f"residual {rep.policy} "
                  f"(norm {rep.norm_before:.3e} -> {rep.norm_after:.3e})")
    n_params = sum(p.numel() for p in state["params"])
    print(f"[model] {cfg.name}: {n_params/1e6:.1f}M params")

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.global_batch)
    loader = iter(make_loader(dc, device=args.device))
    t0 = time.perf_counter()
    done = 0
    while done < args.steps:
        chunk = args.steps - done
        if args.ckpt_dir and args.ckpt_every > 0:
            chunk = min(chunk, args.ckpt_every)
        state = tr.run(state, loader, steps=chunk)
        done += chunk
        if args.ckpt_dir and (args.ckpt_every > 0 or done >= args.steps):
            path = checkpoint.save_train_state(
                args.ckpt_dir, state, interval=tr.tc.interval, names=tr.leaf_names)
            print(f"[ckpt] saved {path} (params + opt + EF residuals)")
    if model.embed["table"].is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = args.steps * args.global_batch * args.seq_len
    last = tr.history[-1]
    print(f"[done] {wall:.1f}s, {tokens/wall:.0f} tok/s, "
          f"final loss {last['loss']:.4f}")


if __name__ == "__main__":
    main()
