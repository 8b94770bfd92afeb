"""The sharded-sync placement gate of the port (the counterpart of
``repro.launch.sharded_gate``): profile one sharded step and check where
its two collective halves are issued.

    python -m repro_torch.launch.sharded_gate --device cpu      # 8 gloo ranks
    python -m torch.distributed.run --nproc-per-node 8 \\
        -m repro_torch.launch.sharded_gate                      # the cards, NCCL

Every rank runs one step of the gate's trainer (the reference gate's REDUCED
sharded COVAP trainer: gpt2-paper, vocabulary 256, seq 32, global batch 8,
``I = 4``, ``overlap="fused"``, ``sync="sharded"``) under ``torch.profiler``,
and :func:`~repro_torch.launch.hlo_analysis.check_sharded_placement` reads
the trace: (a) the gradient buckets are reduce-scattered before the final
backward product (the RS half rides the backward pass, from each bucket's
hook) and (b) the deferred param all-gathers are issued at the step's HEAD,
before the first reduce-scatter (``overlap.issue_param_allgather``, waited
for by ``ParamGather.before_layer``; ``Trainer.gather_events`` holds their
order).  It cross-checks the plan's exposed-bytes claim too: under
``sync="sharded"`` at W=8 the ring-amplified exposed wire bytes per worker
must be at most 0.6x the all-reduce path's.  Without
``torch.distributed.run`` the gate spawns ``--world`` ranks itself.

Prints one ``SHARDED ...`` line (rank 0) and exits non-zero unless the
step is ``placed`` and ``exposed_ratio <= 0.6``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import torch.distributed as dist

from . import overlap_gate
from .hlo_analysis import ShardedPlacementReport, check_sharded_placement

MAX_EXPOSED_RATIO = 0.6


def build_trainer(*, arch: str = "gpt2-paper", vocab_size: int = 256, seq_len: int = 32,
                  global_batch: int = 8, interval: int = 4, overlap: str = "fused",
                  device="cuda"):
    """The gate's REDUCED sharded COVAP trainer on the default process
    group, its fresh state and this rank's first batch."""
    return overlap_gate.build_trainer(arch=arch, vocab_size=vocab_size, seq_len=seq_len,
                                      global_batch=global_batch, interval=interval,
                                      overlap=overlap, sync="sharded", device=device)


def profile_and_check(trainer=None, state=None, batch=None, *, phase: int = 0,
                      min_bytes: int = 1024, device="cuda", **kw) -> ShardedPlacementReport:
    """Profile one step of ``phase`` of ``trainer`` (or of the gate's
    trainer, :func:`build_trainer` with ``kw``) and run
    :func:`~repro_torch.launch.hlo_analysis.check_sharded_placement` on its
    trace."""
    if trainer is None:
        trainer, state, batch = build_trainer(device=device, **kw)
    _, trace = overlap_gate.profile_step(trainer, state, batch, phase=phase)
    return check_sharded_placement(trace, min_bytes=min_bytes, world=trainer.dp_world)


def exposed_ratio(trainer, *, world: int | None = None) -> float:
    """Plan-level acceptance number: the mean exposed wire bytes per worker
    of the sharded plan over one phase cycle, over the same compressor's
    all-reduce plan.  The RS half moves ``(W-1)/W`` of each buffer where
    the all-reduce moves ``2(W-1)/W``, so the ratio sits at about 0.5
    (padding adds epsilon); the gate requires <= 0.6.  ``world`` (default:
    the trainer's) plans both sides at that world, so a trainer without a
    group can be priced at W = 8."""
    from ..train.trainer import make_compressor

    w = trainer.dp_world if world is None else world
    n = trainer.num_phases
    sharded = (trainer.schedules() if world is None else
               [trainer.compressor.plan_phase(trainer.plan, p, world=w) for p in range(n)])
    ar_comp = make_compressor(dataclasses.replace(trainer.tc, sync="allreduce"))
    exposed = sum(s.exposed_wire_bytes(w) for s in sharded)
    dense = sum(ar_comp.plan_phase(trainer.plan, p, world=w).exposed_wire_bytes(w)
                for p in range(len(sharded)))
    return exposed / dense if dense else 1.0


def sharded_line(r: ShardedPlacementReport, ratio: float) -> str:
    return (f"SHARDED num_reduce_scatter={r.num_reduce_scatter} "
            f"num_all_gather={r.num_all_gather} "
            f"rs_before_final_grad={r.rs_before_final_grad} "
            f"ag_before_first_rs={r.ag_before_first_rs} "
            f"placed={r.placed} exposed_ratio={ratio:.3f}")


def _worker(rank: int, world: int, init: str, out: str, device: str) -> None:
    from .mesh import join_spawned

    device = join_spawned(rank, world, init, device)
    try:
        tr, state, batch = build_trainer(device=device)
        r = profile_and_check(tr, state, batch)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"report": dataclasses.asdict(r), "ratio": exposed_ratio(tr)}, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    from .mesh import init_from_env, launched, spawn_ranks

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda: one NCCL rank per card; cpu: gloo processes")
    ap.add_argument("--world", type=int, default=8,
                    help="ranks to spawn without torch.distributed.run")
    args = ap.parse_args(argv)
    if launched():
        dev = init_from_env(args.device)
        try:
            tr, state, batch = build_trainer(device=dev)
            r, ratio = profile_and_check(tr, state, batch), exposed_ratio(tr)
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
                got = json.load(f)
        r, ratio = ShardedPlacementReport(**got["report"]), got["ratio"]
    print(sharded_line(r, ratio))
    if not r.placed:
        print("sharded_gate: the step does not reduce-scatter inside the backward "
              "pass with the param all-gathers at its head", file=sys.stderr)
        return 1
    if ratio > MAX_EXPOSED_RATIO:
        print(f"sharded_gate: exposed wire bytes {ratio:.3f}x the all-reduce path's "
              f"(gate: <= {MAX_EXPOSED_RATIO}x)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
