"""The chaos-recovery gate of the port (the counterpart of
``repro.launch.chaos_gate``): a train run under injected faults must heal
itself through every rung of the recovery ladder.

    python -m repro_torch.launch.chaos_gate                 # the card, full width
    python -m repro_torch.launch.chaos_gate --device cpu    # 2 gloo ranks, REDUCED

On the card it trains full-width gpt2-paper (seq 1024, global batch 8) in
one process, in a one-rank NCCL group; with ``--device cpu`` it trains the
REDUCED config (vocabulary 256, seq 16) in ``WORKERS`` gloo processes,
each on its rows of every global batch.  The scenario (COVAP ``I=2``):

* ``grad_nan@6``: a transient NaN in the params; the nonfinite guard
  trips and **skip-step** restores the pre-corruption copy;
* ``ef_blowup@10``: the EF residual scaled past the watchdog's limit; the
  residual guard enters the ladder at **ef-flush**;
* ``grad_inf@14x3``: a fault that survives three re-encounters, so the
  per-incident skip and flush budgets drain and a **checkpoint rewind**
  follows;
* ``kill@17``: an injected crash; the gate catches
  :class:`~repro_torch.resilience.InjectedCrash`, restores the latest
  guard-owned checkpoint and resumes with the same runtime (so the spent
  fault budgets persist and the kill does not fire again).

Prints one ``CHAOS ...`` line (rank 0) and exits non-zero unless the run
ends at step ``TOTAL_STEPS`` with a finite loss, all three rungs were taken,
the kill and resume ran, and every trip, action and firing is an event of
the telemetry that validates against the schema, 1:1 with its counter.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from .mesh import free_port

FAULT_SPEC = "grad_nan@6,ef_blowup@10,grad_inf@14x3,kill@17"
TOTAL_STEPS = 20
INTERVAL = 2
# strict lag-one (sync_every=1): the schedule above is step-exact (kill@17
# must be reached inside the budget)
GUARDS = dict(ckpt_every=6, residual_check_every=2, max_skips=1, max_flushes=1,
              sync_every=1)
# the REDUCED form's trainer and data, the reference gate's
REDUCED_TC = dict(bucket_bytes=1 << 14, max_buckets=16)
REDUCED_DATA = dict(vocab_size=256, seq_len=16, corpus_tokens=1 << 12)
LR = 3e-3
WORKERS = 2           # gloo processes of the CPU form


def run_chaos(td: str, cfg, *, device="cuda", group=None, seq_len: int = 1024,
              global_batch: int = 8, corpus_tokens: int | None = None,
              tc_kw: dict | None = None) -> dict:
    """Run the kill + resume chaos scenario on ``cfg`` and return what the
    gate checks.  ``td`` holds the checkpoints (``ck``, shared by the ranks)
    and each rank's telemetry (``tel<rank>``).  ``tc_kw`` adds
    ``TrainConfig`` fields (covap at ``I=2`` and AdamW at ``LR`` are the
    gate's)."""
    from .. import checkpoint
    from ..api import _worker_batches
    from ..core.comm import flat_axis_index
    from ..data import DataConfig
    from ..models import build_model
    from ..obs import Telemetry, validate_event
    from ..optim import adamw
    from ..resilience import GuardConfig, InjectedCrash
    from ..train import TrainConfig, Trainer

    model = build_model(cfg, device=device, seed=0)
    tc = TrainConfig(compressor="covap", interval=INTERVAL, log_every=1000,
                     **(tc_kw or {}))
    tr = Trainer(model, adamw(LR), tc, group=group)
    state = tr.init_state()
    dc_kw = dict(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch)
    if corpus_tokens is not None:
        dc_kw["corpus_tokens"] = corpus_tokens
    loader = _worker_batches(DataConfig(**dc_kw), device, group)

    tel_dir = os.path.join(td, f"tel{flat_axis_index(group)}")
    tel = Telemetry(tel_dir)
    ck = os.path.join(td, "ck")
    g = GuardConfig(ckpt_dir=ck, **GUARDS)
    # run until the target: ``steps`` counts loop iterations and every rung
    # consumes some without advancing the step, so each pass tops the
    # budget up; the faults' ``times`` bound the loop
    resumed_from, resume_s = -1, 0.0
    while int(state["step"]) < TOTAL_STEPS:
        try:
            state = tr.run(state, loader, steps=TOTAL_STEPS - int(state["step"]),
                           log=None, telemetry=tel,
                           guards=tr.resilience if tr.resilience is not None else g,
                           faults=None if tr.resilience is not None else FAULT_SPEC)
        except InjectedCrash:
            # the operator's half of the kill: restore the latest guard-owned
            # checkpoint into a fresh state, resume with the same runtime
            t0 = time.perf_counter()
            state, _ = checkpoint.restore_train_state(ck, tr.init_state(),
                                                      names=tr.leaf_names, group=group)
            resume_s = time.perf_counter() - t0
            resumed_from = int(state["step"])
    steps_run = tel.registry.counter("train_steps_total", "optimizer steps completed").value
    # a finite loss through the trainer's own step (the group's mean)
    _, metrics = tr.step(state, next(loader))
    loss = float(metrics["total_loss"])

    summary = tr.resilience.summary()
    tel.save()
    tel.close()
    by_kind: dict[str, int] = {}
    with open(os.path.join(tel_dir, "events.jsonl")) as f:
        for lineno, line in enumerate(f, 1):
            ev = json.loads(line)
            errs = validate_event(ev)
            if errs:
                raise AssertionError(f"chaos gate: events.jsonl:{lineno} invalid "
                                     f"{ev.get('kind')!r} event: {errs}")
            by_kind[ev["kind"]] = by_kind.get(ev["kind"], 0) + 1
    snap = tel.registry.snapshot()

    def counted(prefix: str) -> int:
        return int(sum(v for k, v in snap.items() if k.startswith(prefix)))

    return {
        "loss": loss,
        "resumed_from": resumed_from,
        "resume_s": resume_s,
        "final_step": int(state["step"]),
        "steps_run": int(steps_run),
        "summary": summary,
        "actions": list(tr.resilience.actions),
        "trips": [(t.step, t.guard) for t in tr.resilience.guards.trips],
        "timings": tr.resilience.timings,
        "events": by_kind,
        "counters": {
            "guard_trips_total": counted("guard_trips_total"),
            "recovery_actions_total": counted("recovery_actions_total"),
            "faults_injected_total": counted("faults_injected_total"),
        },
        "trainer": tr,
        "state": state,
    }


def passed(out: dict) -> bool:
    """The gate's pass rule (the reference's)."""
    s = out["summary"]
    rungs = s["actions_by_rung"]
    return (
        math.isfinite(out["loss"])
        and out["resumed_from"] >= 0
        and s["faults"]["by_kind"].get("kill", 0) == 1
        and out["final_step"] == TOTAL_STEPS
        and set(rungs) == {"skip_step", "ef_flush", "rewind"}
        and out["events"].get("guard_trip", 0)
        == out["counters"]["guard_trips_total"] == s["trips"]
        and out["events"].get("recovery", 0)
        == out["counters"]["recovery_actions_total"] == s["actions"]
        and out["events"].get("fault_injected", 0)
        == out["counters"]["faults_injected_total"] == s["faults"]["fired"]
    )


def chaos_line(out: dict, ok: bool) -> str:
    s = out["summary"]
    rungs = s["actions_by_rung"]
    return ("CHAOS loss=%.4f resumed_from=%d trips=%d actions=%d rungs=%s "
            "faults_fired=%d events_ok=%d"
            % (out["loss"], out["resumed_from"], s["trips"], s["actions"],
               ",".join(f"{k}:{v}" for k, v in sorted(rungs.items())),
               s["faults"]["fired"], int(ok)))


def _cpu_worker(rank: int, world: int, init_file: str, td: str) -> None:
    from ..configs import get_reduced

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        cfg = get_reduced("gpt2-paper").with_(vocab_size=REDUCED_DATA["vocab_size"])
        out = run_chaos(td, cfg, device="cpu",
                        group=dist.group.WORLD, seq_len=REDUCED_DATA["seq_len"],
                        global_batch=world,
                        corpus_tokens=REDUCED_DATA["corpus_tokens"], tc_kw=REDUCED_TC)
        ok = passed(out)
        with open(os.path.join(td, f"rank{rank}.json"), "w") as f:
            json.dump({"ok": ok, "line": chaos_line(out, ok),
                       "actions": out["actions"], "trips": out["trips"]}, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda: full width, one process; cpu: REDUCED, gloo ranks")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="chaos_gate_") as td:
        if args.device == "cpu":
            import torch.multiprocessing as mp

            mp.start_processes(_cpu_worker, args=(WORKERS, os.path.join(td, "rdv"), td),
                               nprocs=WORKERS, start_method="spawn")
            ranks = []
            for r in range(WORKERS):
                with open(os.path.join(td, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            agree = all((x["actions"], x["trips"]) == (ranks[0]["actions"], ranks[0]["trips"])
                        for x in ranks)
            ok = agree and all(x["ok"] for x in ranks)
            print(ranks[0]["line"] + f" ranks={WORKERS} ranks_agree={int(agree)}")
        else:
            from ..configs import get_config

            torch.cuda.set_device(0)
            dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                    world_size=1, rank=0)
            try:
                out = run_chaos(td, get_config("gpt2-paper"), device="cuda",
                                group=dist.group.WORLD)
            finally:
                dist.destroy_process_group()
            ok = passed(out)
            print(chaos_line(out, ok))
    if not ok:
        print("chaos gate failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
