"""Serving CLI: continuous batching over the paged KV arena — the
counterpart of ``repro.launch.serve``, with the same flags and ``[serve]``
lines, plus ``--device`` (default ``cuda``; ``--device cpu`` runs on the
CPU).  The parameters are the port's own seeded init.

Batch mode (submit everything, drain, print stage metrics):

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --reduced \\
        --requests 16 --slots 4 --max-new 16

Traffic mode (Poisson arrivals at --qps, latency percentiles):

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --reduced --qps 16

Sweep mode (arrival-rate sweep -> saturation table):

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --reduced \\
        --sweep 2,8,32,128
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config, get_reduced
from ..models import build_model
from ..serve import Engine, ServeConfig, TrafficConfig, run_traffic, sweep


def _print_report(rep) -> None:
    print(f"[serve] qps={rep.qps:<7g} n={rep.num_requests:<4d} "
          f"p50={rep.p50_ms:8.1f}ms p99={rep.p99_ms:8.1f}ms "
          f"ttft_p50={rep.ttft_p50_ms:7.1f}ms "
          f"tok/s={rep.tokens_per_s:7.1f} reasons={rep.finish_reasons}")


def _print_metrics(eng) -> None:
    m = eng.metrics()
    print(f"[serve] prefill={m['prefill_tok_us']:.0f}us/tok "
          f"generate={m['generate_tok_us']:.0f}us/tok "
          f"insert={m['insert_us']:.0f}us")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-paper")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page pool size (0 = every slot can run full-length)")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens per prefill call")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qps", type=float, default=0.0,
                    help="Poisson arrival rate; 0 = batch mode")
    ap.add_argument("--sweep", default="",
                    help="comma-separated qps list, e.g. 2,8,32,128")
    ap.add_argument("--telemetry-dir", default="",
                    help="per-request spans, stage histograms and queue/"
                         "page-pool series into this directory")
    ap.add_argument("--device", default="cuda",
                    help="the device to serve on (cuda unless cpu is given)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=args.device, seed=args.seed)

    telemetry = None
    if args.telemetry_dir:
        from ..obs import Telemetry

        telemetry = Telemetry(args.telemetry_dir)
        telemetry.manifest_once(role="serve", config=vars(args), plan={}, world=1)
    eng = Engine(
        model, None,
        ServeConfig(batch_slots=args.slots, max_len=args.max_len,
                    max_new_tokens=args.max_new,
                    temperature=args.temperature,
                    page_size=args.page_size, num_pages=args.num_pages,
                    prefill_chunk=args.prefill_chunk),
        telemetry=telemetry,
    )
    print(f"[serve] arena: {eng.arena.num_pages} pages x "
          f"{eng.layout.page_bytes()} B "
          f"({eng.arena.nbytes() / 1e6:.1f} MB), page_size={args.page_size}, "
          f"planes={list(eng.layout.plane_dtypes)}")

    base = TrafficConfig(num_requests=args.requests,
                         prompt_len=(2, max(2, args.prompt_len)),
                         vocab_size=cfg.vocab_size, seed=args.seed)

    def _save_telemetry() -> None:
        if telemetry is None:
            return
        paths = telemetry.save()
        telemetry.close()
        print(f"[telemetry] {paths['snapshot']}  {paths['trace']} "
              f"(open in Perfetto)")

    if args.sweep:
        rates = [float(r) for r in args.sweep.split(",") if r]
        for rep in sweep(eng, rates, base):
            _print_report(rep)
        _save_telemetry()
        return
    if args.qps > 0:
        _print_report(run_traffic(eng, TrafficConfig(
            qps=args.qps, num_requests=args.requests,
            prompt_len=base.prompt_len, vocab_size=cfg.vocab_size,
            seed=args.seed)))
        _print_metrics(eng)
        _save_telemetry()
        return

    rng = np.random.default_rng(args.seed)
    rids = []
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(2, args.prompt_len + 1)).tolist()
        rids.append((eng.submit(prompt), prompt))

    t0 = time.perf_counter()
    steps = 0
    while eng.busy:
        eng.step()
        steps += 1
    wall = time.perf_counter() - t0
    total_new = sum(len(eng.results[r].tokens) for r, _ in rids)
    print(f"[serve] {args.requests} requests, {steps} engine steps, "
          f"{wall:.2f}s, {total_new/wall:.1f} tok/s")
    _print_metrics(eng)
    for rid, prompt in rids[:4]:
        c = eng.results[rid]
        print(f"  req {rid}: prompt={prompt[:6]}... -> {c.tokens[:8]} "
              f"[{c.finish_reason}]")
    _save_telemetry()


if __name__ == "__main__":
    main()
