"""The overlap-interleaving gate of the port (the counterpart of
``repro.launch.overlap_gate``): profile one fused-overlap step and check
where its bucket collectives are issued.

    python -m repro_torch.launch.overlap_gate --device cpu      # 8 gloo ranks
    python -m torch.distributed.run --nproc-per-node 8 \\
        -m repro_torch.launch.overlap_gate                      # the cards, NCCL

The reference compiles one fused step on an 8-device CPU mesh and reads its
HLO schedule.  Here every rank runs one step of the gate's trainer under
``torch.profiler`` (``record_shapes=True``), inside
``hlo_analysis.count_collectives``, and
:func:`~repro_torch.launch.hlo_analysis.check_interleaving` reads the trace.
The default is the reference gate's: REDUCED gpt2-paper (vocabulary 256,
seq 32, global batch 8), COVAP ``I = 4``, ``bucket_bytes = 1 << 14``,
``max_buckets = 32``, ``overlap="fused"``.  Without ``torch.distributed.run``
the gate spawns ``--world`` ranks itself (gloo with ``--device cpu``, one
NCCL rank a card otherwise).

Prints one ``OVERLAP ...`` line (rank 0) and exits non-zero unless the step
issues at least one bucket collective before the final backward product.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from .hlo_analysis import InterleaveReport, check_interleaving, count_collectives, load_trace

TC = dict(compressor="covap", bucket_bytes=1 << 14, max_buckets=32, log_every=10 ** 9)


def build_trainer(*, arch: str = "gpt2-paper", vocab_size: int = 256, seq_len: int = 32,
                  global_batch: int = 8, interval: int = 4, overlap: str = "fused",
                  sync: str = "allreduce", arena: bool = False, device="cuda"):
    """The gates' REDUCED COVAP trainer on the default process group (none
    when it is not initialised), its fresh state and this rank's first
    batch (its rows of the global batch)."""
    from ..api import _worker_batches
    from ..configs import get_reduced
    from ..data import DataConfig
    from ..models import build_model
    from ..optim import adamw
    from ..train.trainer import TrainConfig, Trainer

    group = dist.group.WORLD if dist.is_initialized() else None
    cfg = get_reduced(arch).with_(vocab_size=vocab_size)
    model = build_model(cfg, device=device, seed=0)
    tc = TrainConfig(interval=interval, overlap=overlap, sync=sync, arena=arena, **TC)
    tr = Trainer(model, adamw(1e-3), tc, group=group)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch)
    batch = next(iter(_worker_batches(dc, model.device, group)))
    return tr, tr.init_state(), batch


def profile_step(trainer, state, batch, *, phase: int | None = None):
    """Run unprofiled steps until the state's phase is ``phase`` (``None``:
    the one it is at), then one step of it under ``torch.profiler`` and
    :func:`~.hlo_analysis.count_collectives` (the trainer's group as the
    ``"ici"`` link).  -> ``(state, trace)``."""
    if phase is not None:
        while state["step"] % trainer.num_phases != phase % trainer.num_phases:
            state, _ = trainer.step(state, batch)
    dev = state["params"][0].device
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    with count_collectives({trainer.group: "ici"}):
        with profile(activities=activities, record_shapes=True) as prof:
            state, _ = trainer.step(state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    return state, load_trace(prof)


def profile_and_check(trainer=None, state=None, batch=None, *, arch: str = "gpt2-paper",
                      vocab_size: int = 256, seq_len: int = 32, global_batch: int = 8,
                      interval: int = 4, phase: int = 0, min_bytes: int = 1024,
                      device="cuda") -> InterleaveReport:
    """Profile one step of ``phase`` of ``trainer`` (or of the gate's
    REDUCED fused COVAP trainer on the current process group) and run
    :func:`~repro_torch.launch.hlo_analysis.check_interleaving` on its
    trace."""
    if trainer is None:
        trainer, state, batch = build_trainer(
            arch=arch, vocab_size=vocab_size, seq_len=seq_len,
            global_batch=global_batch, interval=interval, device=device)
    _, trace = profile_step(trainer, state, batch, phase=phase)
    return check_interleaving(trace, min_bytes=min_bytes)


def overlap_line(r: InterleaveReport) -> str:
    return (f"OVERLAP num_collectives={r.num_collectives} "
            f"before_final_grad={r.before_final_grad} "
            f"independent={r.independent} interleaved={r.interleaved}")


def _worker(rank: int, world: int, init: str, out: str, device: str) -> None:
    from .mesh import join_spawned

    device = join_spawned(rank, world, init, device)
    try:
        r = profile_and_check(device=device)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(dataclasses.asdict(r), f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    from .mesh import init_from_env, launched, spawn_ranks

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda: one NCCL rank per card; cpu: gloo processes")
    ap.add_argument("--world", type=int, default=8,
                    help="ranks to spawn without torch.distributed.run (the "
                         "reference's 8 devices)")
    args = ap.parse_args(argv)
    if launched():
        dev = init_from_env(args.device)
        try:
            r = profile_and_check(device=dev)
        finally:
            rank = dist.get_rank()
            dist.destroy_process_group()
        if rank:
            return 0
    else:
        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "result.json")
            spawn_ranks(_worker, args.world, args.device, out)
            with open(out) as f:
                r = InterleaveReport(**json.load(f))
    print(overlap_line(r))
    if not r.interleaved:
        print("overlap_gate: the fused step does not issue its collectives inside "
              "the backward pass", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
