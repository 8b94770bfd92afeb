"""End-to-end training driver of the port: one worker, or one process per
GPU under ``torch.distributed.run``.

    python -m repro_torch.launch.train --arch gpt2-paper --reduced \
        --interval auto --steps 20 --seq-len 128 --global-batch 8 --device cpu

    python -m torch.distributed.run --standalone --nproc-per-node 8 \
        -m repro_torch.launch.train --pods 2 --pod-interval 2 ...

Under ``torch.distributed.run`` (its ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` environment) every process joins the default group (NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``), ``--pods N`` cuts the
world into N pods (``launch.mesh.build_groups``) and ``--pod-interval P >
1`` reconciles them every P steps a bucket (hierarchical COVAP); at the
default ``--pod-interval 1`` every step syncs over the whole world, as one
flat group.  Each rank trains on its contiguous rows of every global batch,
and only rank 0 prints and writes ``--history-out``.  ``--dp-workers`` is
the modelled world of ``--interval auto`` only when there is no group; with
one, the world the gradients sync over is (the intra-pod world when
hierarchical).

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
``--resume`` restarts from the last checkpoint.  The run ends when the
committed step (``state["step"]``, which a recovery can set back) is
``--steps`` past where it started; ``[done]`` reports it, and tok/s counts
committed steps only.

``--history-out F`` writes ``{"config", "interval", "history"}`` as JSON,
as the reference's CLI does.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from .. import checkpoint
from ..api import _worker_batches, resolve_interval
from ..configs import get_config, get_reduced
from ..data import DataConfig, make_loader
from ..kernels import launch_counts
from ..models import build_model
from ..optim import adamw, cosine_warmup, sgd
from ..train.trainer import TrainConfig, Trainer
from ..core.comm import world_size
from .mesh import build_groups, init_from_env, launched


def pick_interval(args, cfg, dp_world: int, say=print) -> int:
    """``api.resolve_interval``: ``I = ceil(analytic_ccr)`` for ``auto``,
    modelled on the paper's environment for a ``dp_world``-worker run."""
    choice = resolve_interval(
        args.interval if args.interval in ("auto", "adaptive") else int(args.interval),
        cfg,
        global_batch=args.global_batch, seq_len=args.seq_len,
        dp_world=max(dp_world, 1),
    )
    if choice.auto:
        say(f"[ccr] analytic CCR={choice.ccr:.2f} -> interval I={choice.interval}")
    return choice.interval


def _quiet(*args, **kwargs) -> None:
    pass


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
    ap.add_argument("--history-out", default="",
                    help="write {config, interval, history} as JSON here")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods the torch.distributed.run world is cut into "
                         "(hierarchical COVAP with --pod-interval > 1; at "
                         "--pod-interval 1 the world syncs as one group)")
    ap.add_argument("--pod-interval", type=int, default=1,
                    help="cross-pod reconciliation interval: each bucket's "
                         "params are averaged across pods every P steps "
                         "(1: no pod level, every step syncs over the world)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.interval == "adaptive":
        # as api.fit: the analytic pick first, then the online runtime
        args.adaptive = True
    groups = None
    device = args.device
    if launched():
        device = init_from_env(args.device)
        groups = build_groups(args.pods)
    elif args.pods > 1:
        raise SystemExit("--pods needs a process group: start the CLI under "
                         "python -m torch.distributed.run")
    try:
        _train(args, groups, device)
    finally:
        if groups is not None:
            dist.destroy_process_group()


def _train(args, groups, device) -> None:
    say = print if groups is None or groups.rank == 0 else _quiet
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    # hierarchical only with a pod interval: at --pod-interval 1 every step
    # syncs over the whole world, pods or not, as the reference's
    # pod_interval=1 on a ("pod", "data") mesh does
    hier = groups is not None and groups.n_pods > 1 and args.pod_interval > 1
    group = (groups.intra if hier else groups.world) if groups else None
    interval = pick_interval(args, cfg, world_size(group) if groups else args.dp_workers,
                             say)
    model = build_model(cfg, device=device, seed=args.seed)
    if args.optimizer == "adam":
        opt = adamw(cosine_warmup(args.lr, args.steps // 10 + 1, args.steps))
    else:
        opt = sgd(args.lr, momentum=0.9)

    tc = TrainConfig(compressor=args.compressor, interval=interval,
                     log_every=args.log_every, steps=args.steps,
                     arena=args.arena, sync=args.sync, overlap=args.overlap,
                     pod_interval=args.pod_interval)
    tr = Trainer(model, opt, tc, group=group,
                 pod_group=groups.cross if hier else None)
    if groups is not None:
        say(f"[launch] {groups.world_size} rank(s), {groups.n_pods} pod(s) x "
            f"{groups.intra_size}, backend {dist.get_backend()}, device {device}")
    say(f"[plan] {tr.plan.num_buckets} buckets, "
          f"target {tr.plan.bucket_bytes_target/1e6:.1f} MB, "
          f"{tr.num_phases} phase executable(s)")
    sr = tr.schedule_report()
    say(f"[schedule] mean {sr['mean_bytes_per_step']/1e6:.3f} MB/step "
          f"per worker (dense {sr['dense_bytes']/1e6:.3f} MB, "
          f"volume ratio {sr['volume_ratio']:.2f}x) — static plan, no tracing")
    if args.sync == "sharded":
        # the gathers start at the step's head, one per bucket, and the
        # forward pass waits for each where it first reads it: before the
        # embedding, before layer i (ParamGather.before_layer), or before
        # the final norm and head
        say(f"[schedule] sharded: "
              f"{sr['mean_exposed_wire_bytes_per_step']/1e6:.3f} MB/step "
              f"exposed wire (RS), "
              f"{sr['mean_deferred_bytes_per_step']/1e6:.3f} MB/step "
              f"deferred param AG riding the next forward pass")
    if tr.hierarchical:
        n = len(tr.schedules())
        by_link = {}
        for sched in tr.schedules():
            for link, v in sched.exposed_bytes_by_link().items():
                by_link[link] = by_link.get(link, 0) + v / n
        say(f"[pods] {tr.n_pods} pods x {tr.dp_world}, pod interval "
            f"{tc.pod_interval}, {tr.num_phases} phases; mean bytes/step per "
            f"worker: " + ", ".join(f"{k} {v / 1e6:.3f} MB" for k, v in by_link.items()))
    ckpt_kw = {"names": tr.leaf_names, "group": tr.world_group}

    state = tr.init_state()
    if args.resume and args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
        state, extra = checkpoint.restore_train_state(args.ckpt_dir, state, **ckpt_kw)
        say(f"[ckpt] resumed step {state['step']} "
              f"(EF state: {extra.get('has_comp_state')}, "
              f"saved interval: {extra.get('interval')})")
        if not extra.get("comp_restored", True):
            say("[ckpt] WARNING: saved compressor state is incompatible with "
                  "this config (EF on/off changed, or another world size "
                  f"than the saved {extra.get('world', 1)}); residual "
                  "re-initialised")
        elif extra.get("interval") not in (None, interval):
            # the residual was accumulated under another cadence: cross the
            # boundary through the runtime's transition logic
            state, rep = tr.replan(interval, state, step=state["step"],
                                   old_interval=extra["interval"])
            say(f"[ckpt] interval {extra['interval']} -> {interval}: "
                  f"residual {rep.policy} "
                  f"(norm {rep.norm_before:.3e} -> {rep.norm_after:.3e})")
    n_params = sum(p.numel() for p in state["params"])
    say(f"[model] {cfg.name}: {n_params/1e6:.1f}M params")

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.global_batch)
    loader = (iter(_worker_batches(dc, device, groups.world)) if groups is not None
              else iter(make_loader(dc, device=device)))
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
        say(f"[resilience] {msg}")
    telemetry = None
    if args.telemetry_dir:
        from ..obs import Telemetry

        telemetry = Telemetry(args.telemetry_dir)
        say(f"[telemetry] streaming events to "
              f"{os.path.join(args.telemetry_dir, 'events.jsonl')}")
    t0 = time.perf_counter()
    start = int(state["step"])
    target = start + args.steps
    # loop on the committed step: a recovery can set the state back, so a
    # chunk may commit fewer steps than it runs
    while state["step"] < target:
        chunk = target - state["step"]
        if args.ckpt_dir and args.ckpt_every > 0:
            chunk = min(chunk, args.ckpt_every)
        state = tr.run(state, loader, steps=chunk, autotune=autotune,
                       telemetry=telemetry, guards=resilience, log=say)
        if args.ckpt_dir and (args.ckpt_every > 0 or state["step"] >= target):
            path = checkpoint.save_train_state(
                args.ckpt_dir, state, interval=tr.tc.interval,
                shared=not tr.hierarchical, **ckpt_kw)
            say(f"[ckpt] saved {path} (params + opt + EF residuals)")
            if telemetry is not None:
                telemetry.events.emit("checkpoint", step=int(state["step"]), path=path)
    if model.embed["table"].is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    committed = int(state["step"]) - start
    tokens = committed * args.global_batch * args.seq_len
    last = tr.history[-1]
    aux = f", aux_loss {last['aux_loss']:.4f}" if cfg.is_moe else ""
    say(f"[done] step {state['step']} ({committed} committed), {wall:.1f}s, "
        f"{tokens/wall:.0f} tok/s, final loss {last.get('loss', last['total_loss']):.4f}"
        + aux)
    say(f"[kernels] launches {json.dumps(launch_counts())}")
    if args.adaptive and tr.runtime is not None:
        s = tr.runtime.summary()
        say(f"[autotune] measured CCR {(s['measured_ccr'] or 0.0):.3f}, "
              f"interval {s['interval']}, {s['replans']} re-plan(s)")
    if resilience is not None:
        rs = resilience.summary()
        say(f"[resilience] {rs['trips']} guard trip(s) {rs['trips_by_guard']}, "
              f"{rs['actions']} recovery action(s) {rs['actions_by_rung']}"
              + (f", faults fired {rs['faults']['by_kind']}" if "faults" in rs else ""))
    if args.history_out and say is print:
        os.makedirs(os.path.dirname(args.history_out) or ".", exist_ok=True)
        with open(args.history_out, "w") as f:
            json.dump({"config": vars(args), "interval": interval,
                       "history": tr.history}, f, indent=1)
        say(f"[history] {args.history_out}")
    if telemetry is not None:
        if tr.runtime is not None:
            tr.runtime.finish()     # the planned per-bucket spans -> trace
        paths = telemetry.save()
        telemetry.close()
        say(f"[telemetry] {paths['snapshot']}  {paths['prom']}  "
              f"{paths['trace']} (open in Perfetto)")


if __name__ == "__main__":
    main()
