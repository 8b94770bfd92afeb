"""The hierarchical sharded-sync gate of the port (the counterpart of
``repro.launch.hier_gate``): the planned bytes of every link must be the
bytes the collectives move.

    python -m repro_torch.launch.hier_gate --device cpu     # 2 pods x 4 gloo ranks
    python -m repro_torch.launch.hier_gate                  # the cards, NCCL

The reference compiles one two-level step and reads the bytes of its HLO's
collectives by replica group.  Here every rank runs one full cycle of
hierarchical steps (``lcm(I, pod_interval)`` of them) while every
``all_reduce``, ``reduce_scatter_tensor`` and ``all_gather_into_tensor``
is counted by the group it runs on: the intra-pod group is the ``"ici"``
link, the cross-pod group the ``"dcn"`` link.  Each step's count must equal
its phase's plan exactly: the intra-pod reduce-scatters and the head
all-gather on the ICI, only owned-shard exchanges on the DCN.  The step's
metric average and sharded grad-norm sum are not in the plan: they are
counted apart and printed as ``ici_unplanned=`` / ``dcn_unplanned=``.  The
default is the reference gate's: REDUCED gpt2-paper (vocabulary 256, seq 32,
global batch 8), COVAP ``I = 4``, ``pod_interval = 2``, sharded sync, 2
pods of 4 ranks.

Prints one ``HIER ...`` line (rank 0) with ``match=`` and
``hier_exposed_dcn_ratio=`` (the DCN share of the exposed wire bytes over
one cycle, 0.40 at 2 x 4 as in the reference) and exits non-zero unless
every step matched and the plan has DCN bytes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch.distributed as dist

from .hlo_analysis import count_collectives

TC = dict(compressor="covap", interval=4, bucket_bytes=1 << 14, max_buckets=32,
          log_every=10 ** 9, sync="sharded", pod_interval=2)
DATA = dict(vocab_size=256, seq_len=32, global_batch=8)
N_PODS, INTRA = 2, 4
def planned_bytes_by_link(fn) -> dict[str, int]:
    """What one step of ``fn`` should inject by link: the gradient
    schedule's exposed calls, its deferred head all-gather (phase-
    independent: it covers every bucket, so this phase's deferred bytes are
    the previous phase's) and the cross-pod reconciliation calls."""
    out: dict[str, int] = {}
    parts = [fn.comm_schedule.exposed_bytes_by_link(),
             fn.comm_schedule.deferred_bytes_by_link()]
    if fn.pod_schedule is not None:
        parts.append(fn.pod_schedule.exposed_bytes_by_link())
    for d in parts:
        for link, v in d.items():
            out[link] = out.get(link, 0) + v
    return out


def exposed_dcn_ratio(trainer) -> float:
    """The DCN share of the exposed wire bytes over one full (lcm) phase
    cycle, as the reference computes it."""
    ici = dcn = 0.0
    for s in trainer.schedules():
        by_link = s.exposed_wire_bytes_by_link(trainer.dp_world)
        ici += by_link.get("ici", 0.0)
        dcn += by_link.get("dcn", 0.0)
    total = ici + dcn
    return dcn / total if total else 0.0


def build_trainer(groups, *, device="cpu"):
    """The gate's hierarchical trainer on ``groups``
    (``launch.mesh.build_groups``), its fresh state and this rank's
    batches."""
    from ..api import _worker_batches
    from ..configs import get_reduced
    from ..data import DataConfig
    from ..models import build_model
    from ..optim import adamw
    from ..train.trainer import TrainConfig, Trainer

    cfg = get_reduced("gpt2-paper").with_(vocab_size=DATA["vocab_size"])
    model = build_model(cfg, device=device, seed=0)
    tr = Trainer(model, adamw(1e-3), TrainConfig(**TC),
                 group=groups.intra, pod_group=groups.cross)
    batches = _worker_batches(DataConfig(**DATA), device, groups.world)
    return tr, tr.init_state(), batches


def check(tr, state, batches) -> dict:
    """Run one cycle of ``tr``'s phases, counting each step's collectives;
    -> the per-link totals planned and counted, and each step's match."""
    links = {tr.group: "ici", tr.pod_group: "dcn"}
    planned: dict[str, int] = {}
    counted: dict[str, int] = {}
    unplanned: dict[str, int] = {}
    steps = []
    it = iter(batches)
    for _ in range(tr.num_phases):
        plan = planned_bytes_by_link(tr._phase_fn(state["step"] % tr.num_phases))
        with count_collectives(links) as (got, extra):
            state, _ = tr.step(state, next(it))
        steps.append(got == plan)
        for total, d in ((planned, plan), (counted, got), (unplanned, extra)):
            for link, v in d.items():
                total[link] = total.get(link, 0) + v
    return {"schedule": planned, "counted": counted, "unplanned": unplanned,
            "steps": steps, "match": all(steps)}


def hier_line(r: dict, ratio: float) -> str:
    return (f"HIER ici_schedule={r['schedule'].get('ici', 0)} "
            f"ici_counted={r['counted'].get('ici', 0)} "
            f"dcn_schedule={r['schedule'].get('dcn', 0)} "
            f"dcn_counted={r['counted'].get('dcn', 0)} "
            f"ici_unplanned={r['unplanned'].get('ici', 0)} "
            f"dcn_unplanned={r['unplanned'].get('dcn', 0)} "
            f"steps={len(r['steps'])} match={int(r['match'])} "
            f"hier_exposed_dcn_ratio={ratio:.4f}")


def _worker(rank: int, world: int, init: str, out: str, device: str) -> None:
    from .mesh import build_groups, join_spawned

    device = join_spawned(rank, world, init, device)
    try:
        tr, state, batches = build_trainer(build_groups(N_PODS), device=device)
        r = check(tr, state, batches)
        r["ratio"] = exposed_dcn_ratio(tr)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(r, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda: one NCCL rank per card (8 cards); cpu: gloo processes")
    args = ap.parse_args(argv)
    from .mesh import spawn_ranks

    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "result.json")
        spawn_ranks(_worker, N_PODS * INTRA, args.device, out)
        with open(out) as f:
            r = json.load(f)
    print(hier_line(r, r["ratio"]))
    if not r["match"]:
        print(f"hier_gate: counted bytes diverge from the plan: {r}", file=sys.stderr)
        return 1
    if not r["schedule"].get("dcn"):
        print("hier_gate: the plan has no DCN bytes", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
