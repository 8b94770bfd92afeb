"""Where a training step's time goes on the GPU, from a ``torch.profiler``
trace of ``Trainer.run`` on the ``TrainConfig()`` defaults (or another
``--compressor``).

    python -m repro_torch.launch.profile_train --arch gpt2-paper \
        --seq-len 1024 --global-batch 8 --warmup 3 --steps 4 \
        --trace chiprun_out/train_trace.json

Runs ``--warmup`` steps unprofiled, then profiles ``--steps`` more and
prints, for the profiled window: the host wall time per step, the share of
that wall time in which some kernel ran (the device's busy share), the
device milliseconds per step by kernel group and for the top kernels, and
the host calls per step of QR (``powersgd``) and of the CUDA runtime's
synchronising calls, with their host time.  Needs a GPU; with none it
raises.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config, get_reduced
from ..data import DataConfig, make_loader
from ..models import build_model
from ..optim import adamw, cosine_warmup
from ..train.trainer import TrainConfig, Trainer

# kernel-name fragments, matched in order on the lower-cased name
GROUPS = (
    ("ef_update", ("ef_update_kernel",)),
    ("pack_ef_cast", ("pack_ef_cast_kernel",)),
    ("dequantize_fp8", ("dequantize_fp8_kernel",)),   # before its substring
    ("quantize_fp8", ("quantize_fp8_kernel",)),
    ("sign_compress", ("sign_compress_kernel",)),
    ("lowrank.matmul", ("lowrank_matmul_kernel", "lowrank_splitk_reduce_kernel")),
    ("threshold_filter", ("threshold_filter_kernel",)),
    ("qr", ("geqr", "orgqr", "ungqr", "larf", "householder", "cusolver", "magma")),
    ("nccl", ("nccl",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_")),
    ("softmax/logsumexp", ("softmax", "logsumexp")),
    ("copy/fill", ("copy", "fill", "memset", "memcpy", "cat")),
    ("elementwise/reduce", ("elementwise", "vectorized", "reduce", "unrolled",
                            "foreach")),
)


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-paper")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--compressor", default="covap",
                    choices=["covap", "none", "fp16", "fp8wire", "efsignsgd",
                             "powersgd"])
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", default="", help="write a Chrome trace here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs a GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    total_steps = args.warmup + args.steps
    model = build_model(cfg, device="cuda", seed=0)
    tr = Trainer(model, adamw(cosine_warmup(1.5e-4, total_steps // 10 + 1, total_steps)),
                 TrainConfig(compressor=args.compressor, steps=total_steps))
    it = iter(make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                                     global_batch=args.global_batch), device="cuda"))
    state = tr.run(tr.init_state(), it, steps=args.warmup, log=None)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(state, it, steps=args.steps, log=None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events; not measured")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    by_group: dict[str, float] = defaultdict(float)
    by_name: dict[str, float] = defaultdict(float)
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_group[kernel_group(e.name)] += us
        by_name[e.name] += us
    n = args.steps
    kernel_ms = sum(by_group.values()) / 1e3 / n
    busy = busy_us(spans) / 1e3 / n
    print(f"[profile] {smi} | {cfg.name} {args.compressor} seq {args.seq_len} x batch "
          f"{args.global_batch}, {n} steps after {args.warmup}: wall "
          f"{wall_ms / n:.3f} ms/step, device busy {busy:.3f} ms/step "
          f"({100 * busy / (wall_ms / n):.1f}% of wall, idle "
          f"{100 * (1 - busy / (wall_ms / n)):.1f}%), kernel time "
          f"{kernel_ms:.3f} ms/step in {len(kernels) // n} launches/step")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] group {group:<20s} {us / 1e3 / n:9.3f} ms/step "
              f"{100 * us / 1e3 / n / kernel_ms:5.1f}%")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"[profile] kernel {us / 1e3 / n:9.3f} ms/step  {name[:110]}")
    # host side: QR (does it wait for the device, or loop over the batch?)
    # and every runtime call that synchronises or copies
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if e.key.startswith("aten::linalg_qr") or (
                e.key.startswith("cuda") and ("Synchronize" in e.key or "Memcpy" in e.key)):
            print(f"[profile] host {e.key}: {e.count / n:.1f} calls/step, "
                  f"{e.cpu_time_total / 1e3 / n:.3f} ms/step host time (with children)")


if __name__ == "__main__":
    main()
