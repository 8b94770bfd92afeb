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

``--adaptive`` (implied by ``--interval adaptive``) arms the adaptive
runtime: one ``AdaptiveRuntime`` for the whole run re-plans the interval
from the measured CCR and prints an ``[autotune]`` summary line at the end.
``--telemetry-dir D`` streams ``events.jsonl`` into D and writes
``metrics.prom``, ``metrics.json`` and ``trace.json`` there at the end.

``--guards`` arms the resilience runtime (numeric guards and the
skip-step -> EF-flush -> checkpoint-rewind ladder; the rewind target is
the ``--ckpt-dir`` / ``--ckpt-every`` checkpoint); ``--inject-faults SPEC``
(``kind@step[xTIMES][*SCALE]``, implies ``--guards``) injects seeded
faults, sites drawn from ``--fault-seed``.  One ``ResilienceRuntime``
spans the chunked checkpoint-every calls and prints ``[resilience]``
lines; a ``kill`` fault ends the process with ``InjectedCrash``, and
``--resume`` restarts from the last checkpoint.
"""
from __future__ import annotations

import argparse
import os
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
        args.interval if args.interval in ("auto", "adaptive") else int(args.interval),
        cfg,
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
    ap.add_argument("--adaptive", action="store_true",
                    help="arm the adaptive runtime: re-plan the interval "
                         "online from the measured CCR")
    ap.add_argument("--guards", action="store_true",
                    help="arm the resilience runtime: numeric guards on every "
                         "step and the skip-step -> EF-flush -> checkpoint-"
                         "rewind ladder (rewind needs --ckpt-dir/--ckpt-every)")
    ap.add_argument("--inject-faults", default="",
                    help="seeded chaos schedule, e.g. 'grad_nan@10,ef_blowup@20x2,"
                         "kill@30' (kind@step[xTIMES][*SCALE]; implies --guards)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault-site selection")
    ap.add_argument("--telemetry-dir", default="",
                    help="write events.jsonl (streamed), metrics.prom, "
                         "metrics.json and trace.json into this directory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.interval == "adaptive":
        # as api.fit: the analytic pick first, then the online runtime
        args.adaptive = True

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
    autotune = None
    if args.adaptive:
        # one runtime for the whole run: the chunked (checkpoint-every)
        # calls must not reset the controller's patience and cooldown
        from ..runtime import AdaptiveRuntime

        autotune = AdaptiveRuntime(tr)
    resilience = None
    if args.guards or args.inject_faults:
        # one runtime across the chunked calls: the ladder's budgets and the
        # faults' firing counts must not reset at checkpoint boundaries
        from ..resilience import GuardConfig, ResilienceRuntime, parse_fault_spec

        gcfg = GuardConfig(ckpt_dir=args.ckpt_dir or None,
                           ckpt_every=args.ckpt_every if args.ckpt_dir else 0)
        plan = (parse_fault_spec(args.inject_faults, seed=args.fault_seed)
                if args.inject_faults else None)
        resilience = ResilienceRuntime(tr, guards=gcfg, faults=plan)
        msg = "guards armed (skip-step -> EF-flush -> rewind)"
        if plan is not None:
            msg += (f"; injecting {len(plan.events)} fault(s): "
                    f"{','.join(f'{e.kind}@{e.step}' for e in plan.events)}")
        print(f"[resilience] {msg}")
    telemetry = None
    if args.telemetry_dir:
        from ..obs import Telemetry

        telemetry = Telemetry(args.telemetry_dir)
        print(f"[telemetry] streaming events to "
              f"{os.path.join(args.telemetry_dir, 'events.jsonl')}")
    t0 = time.perf_counter()
    done = 0
    while done < args.steps:
        chunk = args.steps - done
        if args.ckpt_dir and args.ckpt_every > 0:
            chunk = min(chunk, args.ckpt_every)
        state = tr.run(state, loader, steps=chunk, autotune=autotune,
                       telemetry=telemetry, guards=resilience)
        done += chunk
        if args.ckpt_dir and (args.ckpt_every > 0 or done >= args.steps):
            path = checkpoint.save_train_state(
                args.ckpt_dir, state, interval=tr.tc.interval, names=tr.leaf_names)
            print(f"[ckpt] saved {path} (params + opt + EF residuals)")
            if telemetry is not None:
                telemetry.events.emit("checkpoint", step=int(state["step"]), path=path)
    if model.embed["table"].is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = args.steps * args.global_batch * args.seq_len
    last = tr.history[-1]
    print(f"[done] {wall:.1f}s, {tokens/wall:.0f} tok/s, "
          f"final loss {last.get('loss', last['total_loss']):.4f}")
    if args.adaptive and tr.runtime is not None:
        s = tr.runtime.summary()
        print(f"[autotune] measured CCR {(s['measured_ccr'] or 0.0):.3f}, "
              f"interval {s['interval']}, {s['replans']} re-plan(s)")
    if resilience is not None:
        rs = resilience.summary()
        print(f"[resilience] {rs['trips']} guard trip(s) {rs['trips_by_guard']}, "
              f"{rs['actions']} recovery action(s) {rs['actions_by_rung']}"
              + (f", faults fired {rs['faults']['by_kind']}" if "faults" in rs else ""))
    if telemetry is not None:
        if tr.runtime is not None:
            tr.runtime.finish()     # the planned per-bucket spans -> trace
        paths = telemetry.save()
        telemetry.close()
        print(f"[telemetry] {paths['snapshot']}  {paths['prom']}  "
              f"{paths['trace']} (open in Perfetto)")


if __name__ == "__main__":
    main()
