"""Small cells for the benchmark's CPU tests: the configurations' and
traffic mixes' own files with the widths, depth, vocabulary, batch and
bucket size cut, so that a whole run takes seconds on the CPU."""
from __future__ import annotations

import copy
import socket
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {
    "gpt2-paper": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                       head_dim=16, d_ff=128, vocab_size=300),
    "deepseek-moe-16b-2L": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                                head_dim=16, d_ff=32, vocab_size=300, num_experts=8,
                                experts_per_token=2, num_shared_experts=1),
}
CELLS = {"gpt2-paper": "gpt2-paper.covap.b8",
         "deepseek-moe-16b-2L": "deepseek-moe-16b-2L.covap.b8"}
# the small cells' limits: their program computes in float32, so the gaps
# are round-off (about 1e-7 to 1e-4; the small MoE's grad_diff 2.2e-3, its
# 8 experts' near-ties routed apart; CPU runs); every fault and the float8
# control read more
SMALL_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "grad_diff": 1e-2, "change_gap": 1e-3}


def small_cell(config: str = "gpt2-paper", *, compute_dtype: str = "float32",
               overlap: str = "post", cell: str | None = None):
    from bench import harness

    c = harness.load_cell(cell or CELLS[config])
    c = copy.deepcopy(c)
    c.conf.update(SMALL[config], compute_dtype=compute_dtype)
    c.traffic.update(seq_len=32, rows_per_chip=4, bucket_bytes=4096, overlap=overlap)
    c.limits = dict(SMALL_LIMITS)
    return c


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
