"""The benchmark of ``repro_torch``: one run of one cell.

    python3 bench/run.py --workload gpt2-paper.covap.b8 --seed 7 --seconds 30 --trace 0

Reads the cell from ``BENCHMARK.json`` and its files under ``bench/``,
starts one process a chip (this one is rank 0; NCCL over a free local TCP
port), builds the system under test with the seed's weights, runs its
first COVAP cycle, measures ``--seconds`` of steps (``--trace 1``: profiles
two cycles first, then the rest untraced), runs the plain reference of the
first cycle, and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer ones with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit.
Exits non-zero, printing no result, without enough cards, or when JAX or
the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# Python's bytecode cache in a fixed directory of the checkout: the first
# run there compiles the sources torch imports, later runs read them back
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.split("\n")[0].strip()
        return out or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    from bench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"cuda available={torch.cuda.is_available()}, "
              f"count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    harness.cache_dirs()
    children, port = [], args.port
    if args.rank == 0:
        harness.build_kernels(cell)
        port = free_port()
        children = harness.spawn_ranks(
            __file__, ["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                       str(args.seconds), "--trace", str(args.trace)], cell.chips, port)
    try:
        out = harness.run_rank(cell, seed=args.seed, seconds=args.seconds,
                               trace=bool(args.trace), rank=args.rank, world=cell.chips,
                               port=port, device=f"cuda:{args.rank}", t_start=T_START)
    finally:
        codes = [c.wait() for c in children]
    bad = forbidden_modules()
    if bad:
        print(f"bench: loaded forbidden modules {bad}", file=sys.stderr)
        return 3
    if any(codes):
        print(f"bench: a rank failed with exit codes {codes}", file=sys.stderr)
        return 4
    if args.rank != 0:
        return 0
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": out["peak"],
              "power_limit": power_limit()}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"],
            "metrics": {name: {"value": value, "unit": unit_of(cell, name)}
                        for name, value in out["metrics"].items()},
            "device": device}
    if args.trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["window_s"]
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


def unit_of(cell, name: str) -> str:
    for m in cell.end_to_end + cell.per_layer:
        if m["name"] == name:
            return m["unit"]
    raise KeyError(name)


if __name__ == "__main__":
    sys.exit(main())
