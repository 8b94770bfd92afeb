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
import contextlib
import json
import os
import socket
import sys
import tempfile

import torch
import torch.distributed as dist

TC = dict(compressor="covap", interval=4, bucket_bytes=1 << 14, max_buckets=32,
          log_every=10 ** 9, sync="sharded", pod_interval=2)
DATA = dict(vocab_size=256, seq_len=32, global_batch=8)
N_PODS, INTRA = 2, 4
# the step's reductions that are not in the plan: the metric average (on
# the intra-pod group and, hierarchical, on the pod group) and the sharded
# grad-norm sum; the gate counts them apart, as unplanned bytes
UNPLANNED = ("_pmean_metrics", "_sharded_grad_norm")


@contextlib.contextmanager
def count_collectives(links: dict):
    """Count the bytes each worker injects into the collectives of the
    groups in ``links`` (``group -> link name``), by link, as the plan counts
    them: an all-reduce's buffer, a reduce-scatter's whole input, an
    all-gather's local shard.  Calls made inside the trainer's
    :data:`UNPLANNED` functions go to a second dict.  Yields the two
    ``link -> bytes`` dicts it fills, ``(counted, unplanned)``."""
    from ..train import trainer as trainer_mod

    counted: dict[str, int] = {}
    unplanned: dict[str, int] = {}
    inside = [0]
    saved = dist.all_reduce, dist.reduce_scatter_tensor, dist.all_gather_into_tensor
    saved_fns = {name: getattr(trainer_mod, name) for name in UNPLANNED}

    def note(group, t: torch.Tensor):
        link = links.get(group)
        if link is not None:
            into = unplanned if inside[0] else counted
            into[link] = into.get(link, 0) + t.numel() * t.element_size()

    def all_reduce(tensor, *a, group=None, **k):
        note(group, tensor)
        return saved[0](tensor, *a, group=group, **k)

    def reduce_scatter_tensor(output, input, *a, group=None, **k):
        note(group, input)
        return saved[1](output, input, *a, group=group, **k)

    def all_gather_into_tensor(output, input, *a, group=None, **k):
        note(group, input)
        return saved[2](output, input, *a, group=group, **k)

    def unplanned_call(fn):
        def call(*a, **k):
            inside[0] += 1
            try:
                return fn(*a, **k)
            finally:
                inside[0] -= 1
        return call

    dist.all_reduce, dist.reduce_scatter_tensor, dist.all_gather_into_tensor = (
        all_reduce, reduce_scatter_tensor, all_gather_into_tensor)
    for name, fn in saved_fns.items():
        setattr(trainer_mod, name, unplanned_call(fn))
    try:
        yield counted, unplanned
    finally:
        dist.all_reduce, dist.reduce_scatter_tensor, dist.all_gather_into_tensor = saved
        for name, fn in saved_fns.items():
            setattr(trainer_mod, name, fn)


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
    from .mesh import build_groups

    if device == "cpu":
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    else:
        device = f"cuda:{rank}"
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=init, world_size=world, rank=rank)
    try:
        tr, state, batches = build_trainer(build_groups(N_PODS), device=device)
        r = check(tr, state, batches)
        r["ratio"] = exposed_dcn_ratio(tr)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(r, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda: one NCCL rank per card (8 cards); cpu: gloo processes")
    args = ap.parse_args(argv)
    world = N_PODS * INTRA
    if args.device != "cpu":
        from ..device import resolve_device

        resolve_device(args.device)
        if torch.cuda.device_count() < world:
            raise SystemExit(f"hier_gate: {world} ranks need {world} cards, "
                             f"this host has {torch.cuda.device_count()}; "
                             "pass --device cpu for gloo processes")
    with tempfile.TemporaryDirectory() as td:
        init = (f"file://{os.path.join(td, 'init')}" if args.device == "cpu"
                else f"tcp://127.0.0.1:{_free_port()}")
        out = os.path.join(td, "result.json")
        torch.multiprocessing.spawn(_worker, args=(world, init, out, args.device),
                                    nprocs=world, start_method="spawn")
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
