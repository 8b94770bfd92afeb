"""Small cells for the benchmark's CPU tests: the configurations' and
traffic mixes' own files with the widths, depth, vocabulary, batch and
bucket size cut, so that a whole run takes seconds on the CPU.  Each
configuration file gives its small sizes under ``"small"``; the tests run
over ``BENCHMARK.json``'s configurations and cells."""
from __future__ import annotations

import copy
import json
import socket
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = [c["name"] for c in SPEC["configs"]]
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
# the small cells' limits: their program computes in float32, so the gaps
# are round-off (about 1e-7 to 1e-4; the small MoE's grad_diff 2.2e-3, its
# 8 experts' near-ties routed apart; CPU runs); every fault and the float8
# control read more
SMALL_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "grad_diff": 1e-2, "change_gap": 1e-3}


def cell_of(config: str) -> str:
    """The first cell of ``BENCHMARK.json`` that runs ``config``."""
    return next(w["name"] for w in SPEC["workloads"] if w["config"] == config)


def small_cell(config: str | None = None, *, cell: str | None = None):
    """The cell ``cell`` (or ``config``'s first) at its configuration's
    small sizes, computing in float32, on 4 rows of 32 tokens and 4 KiB
    buckets, with the small limits."""
    from bench import harness

    c = copy.deepcopy(harness.load_cell(cell or cell_of(config)))
    c.conf.update(c.conf["small"], compute_dtype="float32")
    c.traffic.update(seq_len=32, rows_per_chip=4, bucket_bytes=4096)
    c.limits = dict(SMALL_LIMITS)
    return c


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
