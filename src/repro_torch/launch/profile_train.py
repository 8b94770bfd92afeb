"""Where a training step's time goes on the GPU, from a ``torch.profiler``
trace of ``Trainer.run`` on the ``TrainConfig()`` defaults (or another
``--compressor``, or ``--overlap fused``, ``--arena``, ``--sync sharded``).

    python -m repro_torch.launch.profile_train --arch gpt2-paper \
        --seq-len 1024 --global-batch 8 --warmup 3 --steps 4 \
        --trace chiprun_out/train_trace.json

Runs ``--warmup`` steps unprofiled, then profiles ``--steps`` more and
prints, for the profiled window: the host wall time per step, the share of
that wall time in which some kernel ran (the device's busy share), the
device milliseconds per step by kernel group and for the top kernels, and
the host calls per step of QR (``powersgd``) and of the CUDA runtime's
synchronising calls, with their host time, and then by program span
(``repro_torch.obs.spans.SPAN_FAMILIES``: ``train/*``, ``moe/*``,
``mla/*``, ``data/*``, the buckets' ``covap_bucket_*`` taken together): the device ms a step of the
kernels launched inside the span (on the launching thread, or on the
stepping thread, which waits inside ``train/backward`` while the autograd
engine's thread launches), the host ms a step inside it, and the device's
idle ms a step that began while it was the innermost span open on the
stepping thread; last the program's counters a step (``moe/*``, with
``moe/held`` under an expert share, and
``optim/params`` beside ``optim/fused_params``, the parameters AdamW's
kernel stepped).  Needs a GPU; with none it raises.
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
from ..obs.spans import SPAN_FAMILIES, counters, reset_counters
from ..optim import adamw, cosine_warmup
from ..train.trainer import TrainConfig, Trainer
from . import hlo_analysis as ha

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "(no program span)"


def _span_key(name: str) -> str:
    return "covap_bucket_*" if name.startswith("covap_bucket_") else name


def span_table(trace: list[dict], steps: int) -> list[tuple[str, float, float, float]]:
    """``(span, device ms, host ms, idle ms)`` a step for every program span
    of a trace (``hlo_analysis.load_trace``'s events); last, the device time
    launched and the idle time begun outside every span.

    A device operation belongs to every span that holds its launch call, on
    the launching thread or on the stepping thread (the one that opened
    ``train/forward``); an idle interval of the device, between the first
    span's start and the last span's end, to the innermost span open on the
    stepping thread when it began."""
    spans: dict = {}
    for prefix in SPAN_FAMILIES:
        for tid, rows in ha.enclosing_spans(trace, prefix).items():
            spans.setdefault(tid, []).extend((s, t, _span_key(n)) for s, t, n in rows)
    if not spans:
        return []
    main = next((tid for tid, rows in spans.items()
                 if any(n == "train/forward" for *_, n in rows)), next(iter(spans)))

    def holding(tid, ts):
        return {n for s, t, n in spans.get(tid, ()) if s <= ts <= t}

    device, launches = ha.launches_by_correlation(trace, cats=DEVICE_CATS)
    dev: dict = defaultdict(list)
    for tid, calls in launches.items():
        for c in calls:
            names = holding(tid, c["ts"]) | holding(main, c["ts"])
            e = device[c["args"]["correlation"]]
            for name in names or (OUTSIDE,):
                dev[name].append((e["ts"], ha.event_end(e)))
    lo = min(s for rows in spans.values() for s, _, _ in rows)
    hi = max(t for rows in spans.values() for _, t, _ in rows)
    edges = [lo] + [x for iv in ha.union([(e["ts"], ha.event_end(e)) for e in device.values()])
                    for x in iv] + [hi]
    idle: dict = defaultdict(float)
    for g0, g1 in zip(edges[::2], edges[1::2]):
        g0, g1 = max(g0, lo), min(g1, hi)
        if g1 > g0:
            at = {"ts": g0, "dur": 0.0, "tid": main}
            idle[ha.innermost_span(spans, at) or OUTSIDE] += g1 - g0
    host: dict = defaultdict(float)
    for rows in spans.values():
        for s, t, name in rows:
            host[name] += t - s
    return [(name, ha.busy_us(dev[name]) / 1e3 / steps, host.get(name, 0.0) / 1e3 / steps,
             idle.get(name, 0.0) / 1e3 / steps) for name in [*sorted(host), OUTSIDE]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-paper")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--compressor", default="covap",
                    choices=["covap", "none", "fp16", "fp8wire", "efsignsgd",
                             "powersgd"])
    ap.add_argument("--overlap", default="post", choices=["post", "fused"])
    ap.add_argument("--arena", action="store_true")
    ap.add_argument("--sync", default="allreduce", choices=["allreduce", "sharded"])
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
                 TrainConfig(compressor=args.compressor, steps=total_steps,
                             overlap=args.overlap, arena=args.arena, sync=args.sync))
    it = iter(make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                                     global_batch=args.global_batch), device="cuda"))
    state = tr.run(tr.init_state(), it, steps=args.warmup, log=None)
    torch.cuda.synchronize()

    reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(state, it, steps=args.steps, log=None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = counters()
    if args.trace:
        prof.export_chrome_trace(args.trace)
    trace = ha.load_trace(args.trace or prof)

    # the device's operations; a ``gpu_user_annotation`` (a span's copy on
    # the device's rows) is not one
    kernels = [e for e in trace if e.get("cat") in DEVICE_CATS]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events; not measured")
    spans = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in kernels]
    by_group: dict[str, float] = defaultdict(float)
    by_name: dict[str, float] = defaultdict(float)
    for e in kernels:
        us = e.get("dur", 0.0)
        by_group[ha.kernel_group(e["name"])] += us
        by_name[e["name"]] += us
    n = args.steps
    kernel_ms = sum(by_group.values()) / 1e3 / n
    busy = ha.busy_us(spans) / 1e3 / n
    print(f"[profile] {smi} | {cfg.name} {args.compressor} {args.overlap} "
          f"arena={'on' if args.arena else 'off'} {args.sync} seq {args.seq_len} x batch "
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
    for name, dev_ms, host_ms, idle_ms in span_table(trace, n):
        print(f"[profile] span {name:<20s} device {dev_ms:9.3f} ms/step  host "
              f"{host_ms:9.3f} ms/step  idle begun {idle_ms:9.3f} ms/step")
    for name, total in sorted(counts.items()):
        print(f"[profile] counter {name:<20s} {total / n:.6g} a step")


if __name__ == "__main__":
    main()
