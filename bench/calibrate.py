"""The readings a cell's limits are set from, on the chip at the cell's own
size: the comparison's numbers for the system under test over many seeds,
for the control (the reference computed from float8 e4m3 operands, put in
the system's place) and for each planted fault (``bench.faults``).
Training's readings need no measured window: each is the first COVAP
cycle against the reference's.

    python3 bench/calibrate.py --workload gpt2-paper.covap.b8 \
        --seeds 11,12,13 --control 11,12,13 --faults half_batch,altered:11,12,13

Prints one JSON line a reading, ``{"seed", "kind", "loss_gap", "grad_gap",
"grad_diff", "change_gap", ...}``, and writes them to ``--out`` too.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False


def jobs_of(args) -> list[tuple[int, str]]:
    jobs = [(int(s), "program") for s in args.seeds.split(",") if s]
    jobs += [(int(s), "control") for s in args.control.split(",") if s]
    for spec in filter(None, args.faults.split(";")):
        kinds, seeds = spec.split(":")
        jobs += [(int(s), k) for k in kinds.split(",") for s in seeds.split(",")]
    return sorted(jobs)


def readings(cell, ranks, jobs, dev) -> list[dict]:
    """Each job's ``(seed, kind)`` reading, in order, on every rank of
    ``ranks``; rank 0 returns them (the others an empty list)."""
    import torch

    from bench import check, harness
    from bench.faults import FAULTS
    from bench.reference import train as ref_train

    refs: dict[int, dict] = {}
    lines = []
    for seed, kind in jobs:
        t0 = time.perf_counter()
        captured = []
        if kind != "control":
            prog = harness.Program(cell, seed, rank=ranks.rank, world=ranks.world,
                                   device=dev, group=ranks.group)
            undo = FAULTS[kind](prog) if kind in FAULTS else None
            try:
                captured = ranks.gather(prog.first_cycle())
            finally:
                if undo:
                    undo()
            del prog
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if ranks.rank == 0:
            if seed not in refs:
                refs[seed] = ref_train.run(cell.conf, cell.traffic, seed=seed,
                                           workers=ranks.world, device=dev)
            if kind == "control":
                captured = [ref_train.run(cell.conf, cell.traffic, seed=seed,
                                          workers=ranks.world, device=dev, mm="fp8")]
            found = check.gaps(captured, refs[seed])
            line = {"seed": seed, "kind": kind, **found,
                    "dropped": refs[seed]["dropped"],
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            lines.append(line)
        ranks.sync()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="", help="kind,kind:seed,seed;...")
    ap.add_argument("--out", default="")
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    from bench import harness
    from bench.run import free_port

    cell = harness.load_cell(args.workload)
    harness.cache_dirs()
    children, port = [], args.port
    if args.rank == 0:
        harness.build_kernels(cell)
        port = free_port()
        children = harness.spawn_ranks(__file__, sys.argv[1:], cell.chips, port)
    dev = torch.device(f"cuda:{args.rank}")
    torch.cuda.set_device(dev)
    ranks = harness.Ranks(args.rank, cell.chips, port, dev)
    lines = []
    try:
        lines = readings(cell, ranks, jobs_of(args), dev)
    finally:
        ranks.close()
        codes = [c.wait() for c in children]
    if args.rank == 0 and args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 1 if any(codes) else 0


if __name__ == "__main__":
    sys.exit(main())
