"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Each phase prints one line; any failure raises and the script exits non-zero.

  device   needs ``torch.cuda``; prints the card and its power limit, turns
           TF32 off for float32 matrix products and convolutions
  build    compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``,
           one ``nvcc`` per source, all started together
  kernels  holds ``ef_update`` and ``pack_ef_cast`` (all four
           specialisations) against their plain PyTorch versions on the card
           (ragged, unaligned, an odd slot offset in a bf16 plane, largest
           segment, whole embedding table, an f16 overflow) and times them
           over one full-width step's segments with CUDA events; then
           ``quantize_fp8`` / ``dequantize_fp8`` bit for bit (ragged, N <
           block, block 64, an offset-1 view, zero, NaN and +-inf blocks,
           448 beside subnormal codes, the largest bucket) and
           ``sign_compress`` (signs bit for bit with +-0, subnormals and NaN;
           partials and scale at rtol 1e-6), each timed over one full-width
           step's buckets; ``lowrank.matmul`` within 1e-5 (|A|@|B|) of
           ``matmul_ref`` (every full-width leaf's three PowerSGD products,
           each on its streaming route and the same bits twice, an
           all-zero M, odd sizes and strided views on the tiled kernel) and
           timed over one step's 33 products, in all and by product kind,
           beside ``torch.bmm`` and the tiled kernel; ``threshold_filter`` bit
           for bit in y and counts (ragged, t = 0, NaN and +-inf, offset 1,
           the largest bucket) and timed over one step's buckets at
           ``sample_threshold`` ratios 0.01 and 0.001
  adamw    one AdamW update on the card against the CPU: moments and
           divisions bit for bit, ``torch.sqrt`` at 1 ulp, the update bit
           for bit where the roots agree
  train    full-width gpt2-paper (190,532,352 parameters), AdamW, seq 1024,
           global batch 8, 5 steps in a one-rank NCCL process group, seven
           times: COVAP I=4 on the ``TrainConfig`` defaults (every loss
           finite, ``ef_update.launches`` == segments x steps), then
           ``arena=True``, ``arena=True`` with a bf16 wire, and
           ``sync="sharded"`` (``pack_ef_cast.launches`` == segments x
           steps and ``ef_update.launches`` == 0 on each; sharded prints
           the order of its head all-gather's issues and waits against the
           layers, and checks it); then the
           flat-bucket path, ``fp8wire`` (``quantize_fp8.launches`` ==
           buckets x steps, ``dequantize_fp8.launches`` == 2 x buckets x
           steps) and ``efsignsgd`` (``sign_compress.launches`` == buckets x
           steps); then the leaf path, ``powersgd`` (rank 2,
           ``lowrank.matmul.launches`` == 33 x steps, 11 x steps on each
           streaming route); then the fused overlap (``overlap="fused"``:
           each bucket's collective started inside the backward pass) on
           the defaults (``ef_update.launches`` == segments x steps), with
           ``arena=True`` and with ``sync="sharded"``
           (``pack_ef_cast.launches`` == segments x steps), each printed
           beside its post run (step ms, tok/s, peak memory), with every
           hook's backward on the forward's stream and the hooks fired in
           ``ReadyOrder``; every other kernel's count must be 0 on each run
           (``threshold_filter``, which no path runs, on all of them).  Each
           run's peak memory is taken after a garbage collection, so that
           it counts the run's own memory
  parity   one step from the trained state on the same gradients: each
           kernel against its plain version, arena against per-segment
           (f32 and bf16 wires) and sharded against allreduce, bit for bit;
           for each flat wire, the kernels against ``use_wire_kernel=False``
           (fp8wire bit for bit; efsignsgd signs bit for bit, values at rtol
           1e-6) and the arena against the per-bucket form, bit for bit;
           for powersgd, the matmul kernel against ``use_wire_kernel=False``:
           approx and residuals at allclose, Q up to QR's column signs;
           ``[parity] fused``: from one state and one batch, each fused
           form (defaults, arena, sharded) against its post form, in synced
           gradients, residuals, and the params, Adam moments and residuals
           after the step, by ``torch.equal`` (a difference is printed with
           its ulps and held at ``FUSED_PARITY_ULPS``)
  ckpt     full width, on the defaults and on ``powersgd``: 2 steps,
           ``checkpoint.save_train_state`` into a temporary directory, 3
           more steps; a fresh trainer restored from it and fed the same 3
           batches equals that run bit for bit (params, Adam's m and v, the
           residuals, PowerSGD's Q, both steps, the losses); prints the
           bytes on disk and the save, verify and restore seconds, and a
           copy with one byte flipped must raise ``CheckpointCorruptError``
           (``ef_update.launches`` == 8 x segments, ``lowrank.matmul`` 8 x
           33)
  replan   on the defaults, 2 steps at I=4, ``Trainer.replan(2)``: the
           residual norm bit for bit the same (``carry``), the old and new
           plan's buckets, segments and phases, 3 more steps with finite
           losses and ``ef_update.launches`` == 3 x the new plan's segments
  sparse   ``[train] topk``, ``dgc``, ``randomk`` and ``oktopk`` (5 steps
           each on the flat-bucket path, no kernel launched), each with its
           plan's bytes per worker per step; ``[parity] oktopk``: on the
           same gradients, ``oktopk`` in the one-rank group (its all-to-all
           and all-gather run) equals ``topk`` bit for bit
  overlap  last of the card runs (the steps after a profiled one run
           slower), after a fresh fused run of 5 steps: one post and one
           fused step under ``torch.profiler``: the host
           order of the ``covap_bucket_*`` spans follows ``ReadyOrder`` up
           to ties, and under fused at least one bucket's ``ef_update``
           kernels start on the device before layer 0's last backward GEMM,
           under post none (the counterpart of
           ``launch/hlo_analysis.check_interleaving``; one card shows where
           each bucket is issued, not overlap across cards)
  small    REDUCED gpt2-paper trained 5 steps on the card and on the CPU
           from the same parameters and batches, on the defaults, with
           ``arena=True`` and with ``powersgd`` (the CPU run is the path the
           tests hold against the JAX reference)

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import socket
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
EF_COEFF = 0.3           # EFSchedule().coefficient(step) for step < 200
EF_BYTES_PER_ELEM = 16   # read g and r, write send and r' (float32 each)
# pack_ef_cast: read g and r, write r' (12 B), plus the wire value of a
# selected element (4 B in float32, 2 B with a bf16/f16 cast)
PACK_BYTES_UNSELECTED = 12
# quantize_fp8 reads 4 B and writes 1 B an element, dequantize_fp8 reads 1 B
# and writes 4 B, sign_compress reads 4 B and writes 1 B; each also moves
# 4 B of scale or partial per block
WIRE_BYTES_PER_ELEM = 5
FP8_BLOCK = 8192
SIGN_BLOCK = 32768
STEPS = 5
# float32 FMA rate outside the tensor cores (H100 SXM data sheet)
F32_FLOPS_PER_S = 67e12
THRESHOLD_BLOCK = 32768
KERNELS = ("ef_covap", "pack_ef_cast", "quantize_fp8", "sign_compress",
           "lowrank_matmul", "threshold_filter")
MATMUL = "lowrank.matmul"      # the counter and record name of lowrank.matmul
# the flat-bucket path: each one full-width run
FLAT_RUNS = (
    ("fp8wire", {"compressor": "fp8wire"}),
    ("efsignsgd", {"compressor": "efsignsgd"}),
)
# the arena and sharded paths beside the TrainConfig defaults, each one
# full-width run
PACK_RUNS = (
    ("arena", {"arena": True}),
    ("arena+bf16", {"arena": True,
                    "compressor_options": {"wire_dtype": "bfloat16"}}),
    ("sharded", {"sync": "sharded"}),
)
# the fused overlap on the three segmented forms, each one full-width run:
# (label, options, the post run it is held against, the EF kernel it runs)
FUSED_RUNS = (
    ("fused", {"overlap": "fused"}, "defaults", "ef_update"),
    ("fused+arena", {"overlap": "fused", "arena": True}, "arena", "pack_ef_cast"),
    ("fused+sharded", {"overlap": "fused", "sync": "sharded"}, "sharded",
     "pack_ef_cast"),
)
# [ckpt]: save after 2 steps, resume 3; each a full-width run
CKPT_RUNS = (
    ("defaults", {}),
    ("powersgd", {"compressor": "powersgd"}),
)
# the sparsifying baselines on the flat-bucket path, each one full-width run
SPARSE_RUNS = ("topk", "dgc", "randomk", "oktopk")
# [parity] fused: the largest float32 ulp distance allowed between a fused
# form and its post form on one step from one state (PERF.md states it)
FUSED_PARITY_ULPS = 0


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def ef_close(got: torch.Tensor, want: torch.Tensor, r: torch.Tensor,
             coeff: float) -> bool:
    """The tests' tolerance: rtol 1e-6, atol 1e-6 * max|c r|; zeros exact."""
    atol = 1e-6 * float((coeff * r).abs().max()) if r.numel() else 0.0
    return (torch.allclose(got, want, rtol=1e-6, atol=atol)
            and torch.equal(got == 0, want == 0))


def abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in float32, 0 where the two are equal (inf == inf)."""
    g, w = got.float(), want.float()
    diff = torch.where(g == w, torch.zeros_like(g), (g - w).abs())
    return float(diff.max()) if diff.numel() else 0.0


def same_floats(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit, where a NaN counts as equal to a NaN."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def finite_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``abs_err`` over the elements where ``want`` is finite."""
    keep = torch.isfinite(want)
    return abs_err(got[keep], want[keep])


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by name; each carries a
    ``launches`` count."""
    from repro_torch.kernels.ef_covap import ef_update
    from repro_torch.kernels.lowrank import matmul
    from repro_torch.kernels.pack_ef_cast import pack_ef_cast
    from repro_torch.kernels.quantize import dequantize_fp8, quantize_fp8
    from repro_torch.kernels.sign_compress import sign_compress
    from repro_torch.kernels.topk_threshold import threshold_filter

    counters = {f.__name__: f for f in (ef_update, pack_ef_cast, quantize_fp8,
                                        dequantize_fp8, sign_compress,
                                        threshold_filter)}
    counters[MATMUL] = matmul
    return counters


def launch_counts(**nonzero) -> dict:
    """The expected launch counts of a run: 0 for every kernel but those
    named (``**{MATMUL: n}`` for the matmul)."""
    return {name: nonzero.get(name, 0) for name in kernel_counters()}


def lowrank_leaves(plan) -> list[int]:
    """The leaves PowerSGD factorises (two or more dimensions); each runs
    three ``lowrank.matmul`` products a step."""
    return [i for i, s in enumerate(plan.leaf_shapes) if len(s) >= 2]


def device_timed(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` runs (CUDA
    events).  A sleep kernel ahead of the start event keeps the stream busy
    while the host enqueues ``fn``'s launches, so the events time the
    launches back to back and not the Python that issues them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_timed(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median host milliseconds of ``fn()`` ending in a synchronise: what a
    caller waits, the Python that issues the launches included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is False: this script "
                         "needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"[device] {name}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, tf32 off", flush=True)
    return name, smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(_build.build, KERNELS))
    for name, (path, log, secs) in zip(KERNELS, built):
        ptxas = "; ".join(
            " ".join(line.split()) for line in log.splitlines()
            if "Used" in line or "spill" in line
        )
        print(f"[build] {name}.cu -> {path.relative_to(ROOT)} in {secs:.2f} s "
              f"(nvcc sm_90a; ptxas: {ptxas or 'cached'})", flush=True)


def full_width_segments(device="cuda"):
    """One flat (g, r) pair per segment of the full-width plan, with the
    phase-0 selection, cut from one buffer the way the main path's segments
    are row slices of the gradient leaves."""
    from repro_torch.configs import get_config
    from repro_torch.core import build_plan, get_compressor
    from repro_torch.models import build_model

    model = build_model(get_config("gpt2-paper"), device="meta")
    plan = build_plan(model.named_leaves())
    selected = set(get_compressor("covap", interval=4).plan_phase(plan, 0).selected)
    numels = [
        (s.numel(plan.leaf_shapes[s.leaf_idx]), b.index in selected, b.index, si)
        for b in plan.buckets for si, s in enumerate(b.segments)
    ]
    total = sum(n for n, *_ in numels)
    gen = torch.Generator(device).manual_seed(1)
    g_all = torch.randn(total, generator=gen, device=device)
    r_all = torch.randn(total, generator=gen, device=device)
    segs, off = [], 0
    for n, sel, b, si in numels:
        segs.append((g_all[off:off + n], r_all[off:off + n], sel, b, si))
        off += n
    return plan, segs, total


def phase_kernels() -> dict:
    from repro_torch.kernels.ef_covap import ef_update
    from repro_torch.kernels.ref import ef_update_ref

    gen = torch.Generator("cuda").manual_seed(0)
    cases = [
        ("ragged", 1_000_003, 0),
        ("offset-1", 1_000_003, 1),
        ("largest-segment", 6_553_344, 0),
        ("embed-table", 50304 * 768, 0),
    ]
    max_err, bitwise = 0.0, True
    for name, n, off in cases:
        g = torch.randn(n + off, generator=gen, device="cuda")[off:]
        r = torch.randn(n + off, generator=gen, device="cuda")[off:]
        for sel in (True, False):
            s, q = ef_update(g, r, EF_COEFF, selected=sel)
            ps, pq = ef_update_ref(g, r, EF_COEFF, selected=sel)
            torch.cuda.synchronize()
            zero = q if sel else s
            check(int(torch.count_nonzero(zero)) == 0,
                  f"ef_update {name} selected={sel}: the zero output is not 0")
            for got, want in ((s, ps), (q, pq)):
                check(ef_close(got, want, r, EF_COEFF),
                      f"ef_update {name} n={n} selected={sel} disagrees with "
                      f"ef_update_ref: max |diff| "
                      f"{float((got - want).abs().max())}")
                max_err = max(max_err, float((got - want).abs().max()))
                bitwise &= torch.equal(got, want)

    plan, segs, total = full_width_segments()
    c = EF_COEFF

    def run_kernel():
        for g, r, sel, *_ in segs:
            ef_update(g, r, c, selected=sel)

    def run_plain():
        for g, r, sel, *_ in segs:
            ef_update_ref(g, r, c, selected=sel)

    def run_library():
        for g, r, *_ in segs:
            torch.add(g, r, alpha=c)

    kernel_ms = device_timed(run_kernel)
    plain_ms = device_timed(run_plain)
    library_ms = device_timed(run_library)
    kernel_wall_ms = wall_timed(run_kernel)
    bound_ms = EF_BYTES_PER_ELEM * total / HBM_BYTES_PER_S * 1e3
    print(f"[kernels] ef_update agrees with ef_update_ref on {len(cases)} "
          f"shapes x 2 (max |err| {max_err:.3g}, bitwise {bitwise}); one "
          f"full-width step = {len(segs)} segments, {total} elements: "
          f"kernel_ms {kernel_ms:.4f}  bound_ms {bound_ms:.4f} "
          f"({EF_BYTES_PER_ELEM} B/elem at 3.35 TB/s)  plain_ms {plain_ms:.4f}  "
          f"library_ms {library_ms:.4f} (torch.add(g, r, alpha=c), computes t "
          f"only)  kernel wall ms with host dispatch {kernel_wall_ms:.4f}",
          flush=True)
    return {
        "name": "ef_update",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ef_covap.cu",
        "replaces": "src/repro/kernels/ef_covap.py:51",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "library_call": "torch.add(g, r, alpha=c): computes t only",
        "timed_work": f"{len(segs)} segments, {total} elements (one step)",
        "wall_ms": kernel_wall_ms,
    }


def phase_pack_kernels() -> dict:
    """``pack_ef_cast`` against ``pack_ef_cast_ref`` on the card, bit for
    bit, for selected x {f32, bf16, f16} and unselected, then timed over one
    full-width step's 42 segments with the phase-0 selection, the wire
    written into the arena planes as the arena path writes it."""
    from repro_torch.core.arena import build_layout
    from repro_torch.kernels.pack_ef_cast import pack_ef_cast_into
    from repro_torch.kernels.ref import pack_ef_cast_ref

    gen = torch.Generator("cuda").manual_seed(2)
    # (name, n, view offset of g and r, element offset of the wire slot,
    #  scale of g)
    cases = [
        ("ragged", 1_000_003, 0, 0, 1.0),
        ("offset-1", 1_000_003, 1, 0, 1.0),
        ("odd-slot", 1_000_003, 0, 1, 1.0),
        ("largest-segment", 6_553_344, 0, 0, 1.0),
        ("embed-table", 50304 * 768, 0, 0, 1.0),
        ("f16-overflow", 65_537, 0, 0, 1e5),
    ]
    specs = [(True, torch.float32), (True, torch.bfloat16),
             (True, torch.float16), (False, torch.float32)]
    max_err, checks = 0.0, 0
    for name, n, off, woff, scale in cases:
        g = (torch.randn(n + off, generator=gen, device="cuda") * scale)[off:]
        r = torch.randn(n + off, generator=gen, device="cuda")[off:]
        if name == "f16-overflow":
            check(bool((g.abs() > 65504).any()), "f16-overflow case has no value "
                  "above 65504")
        for sel, wd in specs:
            plane = torch.zeros(n + woff, dtype=wd, device="cuda")
            r_out = torch.empty(n, device="cuda")
            pack_ef_cast_into(g, r, EF_COEFF, plane[woff:] if sel else None,
                              r_out, selected=sel)
            w, q = pack_ef_cast_ref(g, r, EF_COEFF, selected=sel, wire_dtype=wd)
            torch.cuda.synchronize()
            wire = plane[woff:]
            for got, want, what in ((r_out, q, "r'"), (wire, w, "wire")):
                err = abs_err(got, want)
                max_err = max(max_err, err)
                check(torch.equal(got, want),
                      f"pack_ef_cast {name} n={n} selected={sel} wire={wd}: "
                      f"{what} not bitwise equal to pack_ef_cast_ref "
                      f"(max |diff| {err})")
            check(not bool(plane[:woff].any()),
                  f"pack_ef_cast {name}: wrote outside its slot")
            checks += 1

    plan, segs, total = full_width_segments()
    c = EF_COEFF
    sel_elems = sum(g.numel() for g, _, sel, *_ in segs if sel)
    unsel_elems = total - sel_elems
    sel_buckets = sorted({b for _, _, sel, b, _ in segs if sel})
    r_out = torch.empty(total, device="cuda")
    outs, o = [], 0
    for g, *_ in segs:
        outs.append(r_out[o:o + g.numel()])
        o += g.numel()

    def kernel_fn(wd):
        layout = build_layout(plan, sel_buckets, wire_dtype=wd)
        planes = layout.empty_planes("cuda")
        views = [layout.segment_view(planes, b, si) if sel else None
                 for _, _, sel, b, si in segs]

        def run():
            for (g, r, sel, *_), wv, ro in zip(segs, views, outs):
                pack_ef_cast_into(g, r, c, wv, ro, selected=sel)
        return run

    def run_plain():
        for g, r, sel, *_ in segs:
            pack_ef_cast_ref(g, r, c, selected=sel)

    def run_plain_bf16():
        for g, r, sel, *_ in segs:
            pack_ef_cast_ref(g, r, c, selected=sel, wire_dtype=torch.bfloat16)

    def run_library():
        for g, r, *_ in segs:
            torch.add(g, r, alpha=c)

    run_kernel = kernel_fn(None)
    kernel_ms = device_timed(run_kernel)
    kernel_bf16_ms = device_timed(kernel_fn(torch.bfloat16))
    plain_ms = device_timed(run_plain)
    plain_bf16_ms = device_timed(run_plain_bf16)
    library_ms = device_timed(run_library)
    kernel_wall_ms = wall_timed(run_kernel)
    bytes_f32 = (EF_BYTES_PER_ELEM * sel_elems + PACK_BYTES_UNSELECTED * unsel_elems)
    bytes_bf16 = ((EF_BYTES_PER_ELEM - 2) * sel_elems
                  + PACK_BYTES_UNSELECTED * unsel_elems)
    bound_ms = bytes_f32 / HBM_BYTES_PER_S * 1e3
    bound_bf16_ms = bytes_bf16 / HBM_BYTES_PER_S * 1e3
    print(f"[kernels] pack_ef_cast bitwise equal to pack_ef_cast_ref on "
          f"{len(cases)} cases x {len(specs)} specialisations (max |err| "
          f"{max_err:.3g}); one full-width step = {len(segs)} segments, "
          f"{sel_elems} selected + {unsel_elems} unselected elements: "
          f"kernel_ms {kernel_ms:.4f}  bound_ms {bound_ms:.4f} "
          f"({bytes_f32} B at 3.35 TB/s, {bound_ms / kernel_ms:.1%} of the "
          f"HBM rate)  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f} "
          f"(torch.add(g, r, alpha=c), computes t only)  bf16 wire: "
          f"kernel_ms {kernel_bf16_ms:.4f}  bound_ms {bound_bf16_ms:.4f}  "
          f"plain_ms {plain_bf16_ms:.4f}  library: no single call (EF, a cast "
          f"and a subtraction)  kernel wall ms with host dispatch {kernel_wall_ms:.4f}",
          flush=True)
    check(checks == len(cases) * len(specs), "pack_ef_cast: checks skipped")
    return {
        "name": "pack_ef_cast",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pack_ef_cast.cu",
        "replaces": "src/repro/kernels/pack_ef_cast.py:69",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "library_call": "torch.add(g, r, alpha=c): computes t only",
        "timed_work": f"{len(segs)} segments, {sel_elems} selected + "
                      f"{unsel_elems} unselected elements (one phase-0 step, "
                      f"f32 wire into the arena planes)",
        "wall_ms": kernel_wall_ms,
        "bf16_wire_ms": kernel_bf16_ms,
        "bf16_wire_bound_ms": bound_bf16_ms,
        "bf16_wire_plain_ms": plain_bf16_ms,
    }


def full_width_buckets(device="cuda"):
    """One flat float32 vector per bucket of the full-width plan (every
    bucket is synced every step on the flat-bucket path), cut from one
    buffer the way an arena plane holds them."""
    from repro_torch.configs import get_config
    from repro_torch.core import build_plan
    from repro_torch.models import build_model

    model = build_model(get_config("gpt2-paper"), device="meta")
    plan = build_plan(model.named_leaves())
    numels = [b.numel for b in plan.buckets]
    total = sum(numels)
    gen = torch.Generator(device).manual_seed(4)
    buf = torch.randn(total, generator=gen, device=device)
    views, off = [], 0
    for n in numels:
        views.append(buf[off:off + n])
        off += n
    return plan, views, total


def _fp8_case(n, block, offset, special, gen):
    """Normals at scales from e^-8 to e^8, viewed at element ``offset`` of
    a plane.  ``special``: block 0 zero, a NaN in block 1, +inf and -inf in
    block 2, and in block 3 448 beside values that quantize to subnormal
    codes (scale 1)."""
    x = torch.randn(n + offset, generator=gen, device="cuda")
    x = (x * torch.exp(torch.rand(n + offset, generator=gen, device="cuda") * 16 - 8))
    x = x[offset:]
    if special:
        x[:block] = 0.0
        x[block + 3] = float("nan")
        x[2 * block + 1], x[2 * block + 2] = float("inf"), float("-inf")
        blk = x[3 * block:4 * block]
        blk *= 1e-3 / blk.abs().max()
        x[3 * block], x[3 * block + 1] = 448.0, -0.0
    return x


def phase_wire_kernels() -> list[dict]:
    """``quantize_fp8`` and ``dequantize_fp8`` against their plain versions
    bit for bit, ``sign_compress`` with its signs bit for bit and its
    partials and scale at rtol 1e-6; then each timed over one full-width
    step's 35 buckets (one call per bucket, outputs preallocated, as the
    flat-bucket path calls them)."""
    from repro_torch.kernels.quantize import dequantize_fp8, quantize_fp8
    from repro_torch.kernels.ref import (
        dequantize_fp8_ref,
        quantize_fp8_ref,
        sign_compress_partials_ref,
    )
    from repro_torch.kernels.sign_compress import sign_compress, sign_compress_partials

    plan, bufs, total = full_width_buckets()
    largest = max(x.numel() for x in bufs)
    gen = torch.Generator("cuda").manual_seed(5)
    # (name, n, block, view offset, special blocks)
    cases = [
        ("ragged", 1_000_003, FP8_BLOCK, 0, False),
        ("below-block", 5000, FP8_BLOCK, 0, False),
        ("block-64", 10_007, 64, 0, True),
        ("offset-1", 100_003, FP8_BLOCK, 1, True),
        ("zero-nan-inf", 5 * FP8_BLOCK + 7, FP8_BLOCK, 0, True),
        ("largest-bucket", largest, FP8_BLOCK, 0, False),
    ]
    q_err = dq_err = 0.0
    for name, n, block, off, special in cases:
        x = _fp8_case(n, block, off, special, gen)
        q, sc = quantize_fp8(x, block)
        d = dequantize_fp8(q, sc, block)
        rq, rs = quantize_fp8_ref(x, block)
        rd = dequantize_fp8_ref(rq, rs, block)
        torch.cuda.synchronize()
        q_err = max(q_err, finite_err(q.float(), rq.float()), finite_err(sc, rs))
        dq_err = max(dq_err, finite_err(d, rd))
        check(torch.equal(q.view(torch.uint8), rq.view(torch.uint8)),
              f"quantize_fp8 {name} n={n} block={block}: q not bitwise equal to "
              f"quantize_fp8_ref ({int((q.view(torch.uint8) != rq.view(torch.uint8)).sum())}"
              f" codes differ)")
        check(same_floats(sc, rs), f"quantize_fp8 {name}: scales not bitwise equal "
              f"(max |diff| {finite_err(sc, rs)})")
        check(same_floats(d, rd), f"dequantize_fp8 {name}: not bitwise equal to "
              f"dequantize_fp8_ref (max |diff| {finite_err(d, rd)})")
        if special:
            check(float(sc[0]) == float(torch.tensor(1e-12)) and bool(torch.isnan(sc[1]))
                  and float(sc[2]) == float("inf") and float(sc[3]) == 1.0
                  and bool(((q[3 * block:4 * block].view(torch.uint8) & 0x78) == 0).any()),
                  f"quantize_fp8 {name}: special blocks gave scales {sc[:4].tolist()}")

    sign_cases = [("ragged", 1_000_003, 0), ("offset-3", 32_771, 3),
                  ("largest-bucket", largest, 0)]
    signs_err = partial_err = 0.0
    for name, n, off in sign_cases:
        x = torch.randn(n + off, generator=gen, device="cuda")[off:]
        xs = x.clone()
        xs[:7] = torch.tensor([0.0, -0.0, 1e-45, -1e-45, float("nan"),
                               float("inf"), float("-inf")], device="cuda")
        signs, partials = sign_compress_partials(xs)
        signs2, scale = sign_compress(x)
        rsigns, rpartials = sign_compress_partials_ref(xs)
        rsigns2, _ = sign_compress_partials_ref(x)
        torch.cuda.synchronize()
        check(torch.equal(signs, rsigns) and torch.equal(signs2, rsigns2),
              f"sign_compress {name}: signs not bitwise equal to the plain version")
        check(signs[:7].tolist() == [1, 1, 1, -1, -1, 1, -1],
              f"sign_compress {name}: special signs {signs[:7].tolist()}")
        _, p_clean = sign_compress_partials(x)
        _, rp_clean = sign_compress_partials_ref(x)
        want_scale = x.abs().mean()
        torch.cuda.synchronize()
        for got, want, what in ((p_clean, rp_clean, "partials"),
                                (scale, want_scale, "scale")):
            err = float(((got - want).abs() / want.abs()).max())
            partial_err = max(partial_err, abs_err(got, want))
            check(err <= 1e-6, f"sign_compress {name}: {what} off by {err:.3g} "
                  "relative (rtol 1e-6)")
        check(bool(torch.isnan(partials[0])) and bool(torch.isnan(rpartials[0]))
              and bool(torch.allclose(partials[1:], rpartials[1:], rtol=1e-6, atol=0)),
              f"sign_compress {name}: partials with a NaN and infs differ")
        signs_err = max(signs_err, abs_err(signs.float(), rsigns.float()))

    # ---- one full-width step's buckets -----------------------------------
    nbs = [-(-x.numel() // FP8_BLOCK) for x in bufs]
    qs = [torch.empty(x.numel(), dtype=torch.float8_e4m3fn, device="cuda") for x in bufs]
    ss = [torch.empty(nb, device="cuda") for nb in nbs]
    outs = [torch.empty(x.numel(), device="cuda") for x in bufs]
    sgs = [torch.empty(x.numel(), dtype=torch.int8, device="cuda") for x in bufs]

    def run_quant():
        for x, q, sc in zip(bufs, qs, ss):
            quantize_fp8(x, FP8_BLOCK, q_out=q, scales_out=sc)

    def run_quant_plain():
        for x in bufs:
            quantize_fp8_ref(x, FP8_BLOCK)

    def run_dequant():
        for q, sc, o in zip(qs, ss, outs):
            dequantize_fp8(q, sc, FP8_BLOCK, out=o)

    def run_dequant_plain():
        for q, sc in zip(qs, ss):
            dequantize_fp8_ref(q, sc, FP8_BLOCK)

    def run_sign():
        for x, sg in zip(bufs, sgs):
            sign_compress_partials(x, SIGN_BLOCK, signs_out=sg)

    def run_sign_plain():
        for x in bufs:
            sign_compress_partials_ref(x, SIGN_BLOCK)

    run_quant()
    times = {}
    for key, fn in (("quant", run_quant), ("quant_plain", run_quant_plain),
                    ("dequant", run_dequant), ("dequant_plain", run_dequant_plain),
                    ("sign", run_sign), ("sign_plain", run_sign_plain)):
        times[key] = device_timed(fn)
    walls = {k: wall_timed(fn) for k, fn in (("quant", run_quant),
                                              ("dequant", run_dequant),
                                              ("sign", run_sign))}
    fp8_blocks = sum(nbs)
    sign_blocks = sum(-(-x.numel() // SIGN_BLOCK) for x in bufs)
    bytes_fp8 = WIRE_BYTES_PER_ELEM * total + 4 * fp8_blocks
    bytes_sign = WIRE_BYTES_PER_ELEM * total + 4 * sign_blocks
    bound_fp8 = bytes_fp8 / HBM_BYTES_PER_S * 1e3
    bound_sign = bytes_sign / HBM_BYTES_PER_S * 1e3
    work = f"{len(bufs)} buckets, {total} elements (one full-width step)"
    for key, label, bound in (("quant", "quantize_fp8", bound_fp8),
                              ("dequant", "dequantize_fp8", bound_fp8),
                              ("sign", "sign_compress", bound_sign)):
        print(f"[kernels] {label}: {work}: kernel_ms "
              f"{times[key]:.4f}  bound_ms {bound:.4f} ({bound / times[key]:.1%} of "
              f"the HBM rate)  plain_ms {times[key + '_plain']:.4f}  library_ms "
              f"none (no single PyTorch call computes it)  kernel wall ms with "
              f"host dispatch {walls[key]:.4f}", flush=True)
    print(f"[kernels] quantize_fp8 and dequantize_fp8 bitwise equal to their "
          f"plain versions on {len(cases)} cases; sign_compress signs bitwise "
          f"equal on {len(sign_cases)} cases, partials and scale within rtol "
          f"1e-6 (max |err| {partial_err:.3g})", flush=True)
    common = {"route": "cuda", "bound_by": "bytes", "library_ms": None,
              "library_call": "none: no single PyTorch call computes it",
              "timed_work": work, "launches": None}
    return [
        dict(common, name="quantize_fp8",
             source="src/repro_torch/kernels/csrc/quantize_fp8.cu",
             replaces="src/repro/kernels/quantize.py:36", max_abs_err=q_err,
             ms=times["quant"], plain_ms=times["quant_plain"], bound_ms=bound_fp8,
             wall_ms=walls["quant"]),
        dict(common, name="dequantize_fp8",
             source="src/repro_torch/kernels/csrc/quantize_fp8.cu",
             replaces="src/repro/kernels/quantize.py:60", max_abs_err=dq_err,
             ms=times["dequant"], plain_ms=times["dequant_plain"], bound_ms=bound_fp8,
             wall_ms=walls["dequant"]),
        dict(common, name="sign_compress",
             source="src/repro_torch/kernels/csrc/sign_compress.cu",
             replaces="src/repro/kernels/sign_compress.py:22",
             max_abs_err=max(signs_err, partial_err),
             ms=times["sign"], plain_ms=times["sign_plain"], bound_ms=bound_sign,
             wall_ms=walls["sign"]),
    ]


def leaf_products(seed: int, device="cuda"):
    """PowerSGD's three products for every full-width leaf of two or more
    dimensions, on normal M and Q, as ``execute_leaf`` chains them: ``(name,
    A, B, trans_a, trans_b)`` for ``P = M@Q``, ``Q' = M^T@P`` and ``P@Q'^T``,
    with P orthonormalised by ``torch.linalg.qr`` and each product fed the
    plain version's result of the one before."""
    from repro_torch.configs import get_config
    from repro_torch.core import build_plan
    from repro_torch.kernels.ref import matmul_ref
    from repro_torch.models import build_model

    plan = build_plan(build_model(get_config("gpt2-paper"), device="meta").named_leaves())
    gen = torch.Generator(device).manual_seed(seed)
    products = []
    for i in lowrank_leaves(plan):
        shape = plan.leaf_shapes[i]
        M = torch.randn(shape, generator=gen, device=device)
        M = M.unsqueeze(0) if M.dim() == 2 else M
        Q = torch.randn((M.shape[0], M.shape[-1], 2), generator=gen, device=device)
        P, _ = torch.linalg.qr(matmul_ref(M, Q))
        Qn = matmul_ref(M, P, trans_a=True)
        name = plan.leaf_paths[i]
        products += [(f"{name} P=M@Q", M, Q, False, False),
                     (f"{name} Q'=M^T@P", M, P, True, False),
                     (f"{name} P@Q'^T", P, Qn, False, True)]
    return products


def matmul_within_bound(got, want, a, b, trans_a, trans_b) -> float:
    """The largest ``|got - want| / (|A| @ |B|)`` over the elements (0 where
    both are 0); the check is that it stays within 1e-5."""
    from repro_torch.kernels.ref import matmul_ref

    scale = matmul_ref(a.abs(), b.abs(), trans_a=trans_a, trans_b=trans_b)
    diff = (got - want).abs()
    check(bool((diff <= 1e-5 * scale).all()),
          f"lowrank.matmul: |got - want| above 1e-5 (|A|@|B|): largest ratio "
          f"{float((diff / scale.clamp_min(1e-30)).max()):.3g}")
    return float((diff / scale.clamp_min(1e-30)).max())


def product_bytes(a, b, trans_a, trans_b) -> tuple[int, int]:
    """Bytes a product must move (each operand read once, C written once)
    and its flops."""
    B, m, kk = a.shape[0], a.shape[2 if trans_a else 1], a.shape[1 if trans_a else 2]
    n = b.shape[1 if trans_b else 2]
    return 4 * (a.numel() + b.numel() + B * m * n), 2 * B * m * n * kk


def launch_fit(products, matmul, launches: int = 10) -> tuple[float, float]:
    """Each product's device time, over ``launches`` back-to-back launches
    of it, fitted by least squares as ``fixed + bytes / rate`` over the
    products: -> (rate in TB/s, fixed microseconds a launch).  The rate is
    what a kernel streams at once running; the fixed part is what a launch
    costs besides (ramp-up, tail, a split's second pass)."""
    xs, ys = [], []
    for _, a, b, ta, tb in products:
        t = device_timed(lambda: [matmul(a, b, trans_a=ta, trans_b=tb)
                                  for _ in range(launches)], reps=10) / launches
        xs.append(product_bytes(a, b, ta, tb)[0])
        ys.append(t * 1e-3)
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    return 1 / slope / 1e12, (my - slope * mx) * 1e6


def tiled_matmul(a, b, trans_a, trans_b):
    """The same product through the general tiled kernel of
    ``csrc/lowrank_matmul.cu``, launched directly, for its time beside the
    streaming routes'."""
    from repro_torch.kernels import lowrank

    Ba, m, n, k, sa, sb = lowrank._operands(a, b, trans_a, trans_b)
    workspace, launch = lowrank._launchers()["tiled"]
    need = workspace(Ba, m, n, k)
    out = torch.empty((Ba, m, n), device=a.device)
    ws = torch.empty(max(need, 1), device=a.device)
    err = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(), need,
                 Ba, m, n, k, *sa, *sb, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"tiled lowrank kernel launch failed: cudaError {err}")
    return out


def phase_lowrank_kernels() -> dict:
    """``lowrank.matmul`` against ``matmul_ref`` on the card, within
    ``1e-5 (|A| @ |B|)`` elementwise: every full-width leaf's three products
    (each must take its streaming route, and give the same bits twice), an
    all-zero M, odd sizes on both tile shapes, and operands that are
    strided views (the tiled kernel); an all-zero leaf through
    ``LowRank.execute_leaf`` stays finite.  Then the 33 products of one
    full-width step, timed, in all and by product kind, beside the tiled
    kernel on the same products."""
    from repro_torch.core.stages import LowRank
    from repro_torch.kernels.lowrank import ROUTES, matmul
    from repro_torch.kernels.ref import matmul_ref

    products = leaf_products(6)
    gen = torch.Generator("cuda").manual_seed(7)
    Z = torch.zeros(1, 50304, 768, device="cuda")
    Zq = torch.randn(1, 768, 2, generator=gen, device="cuda")
    Zp, _ = torch.linalg.qr(matmul_ref(Z, Zq))
    odd_a = torch.randn(3, 1001, 517, generator=gen, device="cuda")
    odd_b = torch.randn(3, 517, 3, generator=gen, device="cuda")
    odd_w = torch.randn(3, 517, 129, generator=gen, device="cuda")
    big = torch.randn(2, 700, 2 * 901, generator=gen, device="cuda")
    view = big[:, :, ::2]                        # strides (1261400, 1802, 2)
    cases = products + [
        ("zero M P=M@Q", Z, Zq, False, False),
        ("zero M Q'=M^T@P", Z, Zp, True, False),
        ("odd 1001x517@517x3", odd_a, odd_b, False, False),
        ("odd 1001x517@517x129", odd_a, odd_w, False, False),
        ("odd, B in column-major strides", odd_a,
         odd_b.transpose(1, 2).contiguous().transpose(1, 2), False, False),
        ("strided view M^T@P", view, torch.randn(2, 700, 2, generator=gen, device="cuda"),
         True, False),
        ("strided view P@Q'^T", torch.randn(2, 700, 2, generator=gen, device="cuda"),
         view.transpose(1, 2)[:, :, :2], False, True),
    ]
    worst = max_err = 0.0
    taken = []
    for name, a, b, ta, tb in cases:
        before = dict(matmul.launches_by_route)
        got = matmul(a, b, trans_a=ta, trans_b=tb)
        want = matmul_ref(a, b, trans_a=ta, trans_b=tb)
        torch.cuda.synchronize()
        moved = [r for r in ROUTES if matmul.launches_by_route[r] != before[r]]
        check(len(moved) == 1 and matmul.launches_by_route[moved[0]] == before[moved[0]] + 1,
              f"lowrank.matmul {name}: launches by route moved {moved}")
        taken.append(moved[0])
        worst = max(worst, matmul_within_bound(got, want, a, b, ta, tb))
        max_err = max(max_err, abs_err(got, want))
        if len(taken) <= len(products):
            check(torch.equal(got, matmul(a, b, trans_a=ta, trans_b=tb)),
                  f"lowrank.matmul {name}: two runs gave other bits")
    kinds = {"P=M@Q": "rowdot", "Q'=M^T@P": "colacc", "P@Q'^T": "outer"}
    for (name, *_), r in zip(products, taken):
        check(r == kinds[name.rsplit(" ", 1)[1]],
              f"lowrank.matmul {name} took the {r} route, not its streaming one")
    check(taken[len(products):len(products) + 2] == ["rowdot", "colacc"],
          f"lowrank.matmul: the all-zero M took {taken[len(products):len(products) + 2]}")
    check(all(r == "tiled" for r in taken[len(products) + 2:]),
          f"lowrank.matmul: odd and strided cases took {taken[len(products) + 2:]}")
    print(f"[kernels] lowrank.matmul routes of the {len(products)} full-width "
          f"products: " + "; ".join(f"{name}: {r}" for (name, *_), r
                                    in zip(products, taken)), flush=True)
    check(not matmul(Z, Zq).any(), "lowrank.matmul: an all-zero M gave nonzero P")
    approx, qn = LowRank(2).execute_leaf(Z[0], Zq, None, use_kernel=True)
    torch.cuda.synchronize()
    check(not approx.any() and bool(torch.isfinite(qn).all()),
          "LowRank.execute_leaf on an all-zero leaf: approx not 0 or Q not finite")
    del Z, Zp, odd_a, odd_b, odd_w, big, view, approx, qn

    # ---- one full-width step's 33 products -------------------------------
    def runner(fn):
        def run():
            for _, a, b, ta, tb in products:
                fn(a, b, ta, tb)
        return run

    def library(a, b, ta, tb):
        torch.bmm(a.transpose(1, 2) if ta else a, b.transpose(1, 2) if tb else b)

    run_kernel = runner(lambda a, b, ta, tb: matmul(a, b, trans_a=ta, trans_b=tb))
    kernel_ms = device_timed(run_kernel)
    plain_ms = device_timed(runner(
        lambda a, b, ta, tb: matmul_ref(a, b, trans_a=ta, trans_b=tb)))
    library_ms = device_timed(runner(library))
    tiled_ms = device_timed(runner(tiled_matmul))
    kernel_wall_ms = wall_timed(run_kernel)
    by_kind, tiled_by_kind, kind_lines, fits = {}, {}, [], {}
    for k, (kind, r) in enumerate(kinds.items()):
        sub = products[k::3]
        by_kind[kind] = device_timed(lambda sub=sub: [
            matmul(a, b, trans_a=ta, trans_b=tb) for _, a, b, ta, tb in sub])
        tiled_by_kind[kind] = device_timed(lambda sub=sub: [
            tiled_matmul(a, b, ta, tb) for _, a, b, ta, tb in sub])
        kb = sum(product_bytes(a, b, ta, tb)[0] for _, a, b, ta, tb in sub)
        kbound = kb / HBM_BYTES_PER_S * 1e3
        rate, fixed = launch_fit(sub, matmul)
        fits[r] = {"rate_tb_s": rate, "fixed_us": fixed}
        kind_lines.append(
            f"{kind} ({r}, {len(sub)} products, {kb} B): {by_kind[kind]:.4f} ms, "
            f"{kb / by_kind[kind] / 1e6:.1f} GB/s, {kbound / by_kind[kind]:.1%} of its "
            f"bound {kbound:.4f} ms (tiled kernel {tiled_by_kind[kind]:.4f} ms); "
            f"per product, least squares: {rate:.3f} TB/s + {fixed:.2f} us a launch")
    nbytes = sum(product_bytes(a, b, ta, tb)[0] for _, a, b, ta, tb in products)
    flops = sum(product_bytes(a, b, ta, tb)[1] for _, a, b, ta, tb in products)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    print("[kernels] lowrank.matmul by product kind: " + "; ".join(kind_lines),
          flush=True)
    print(f"[kernels] lowrank.matmul within 1e-5 (|A|@|B|) of matmul_ref on "
          f"{len(cases)} cases (largest ratio {worst:.3g}, max |err| {max_err:.3g}); "
          f"an all-zero leaf through execute_leaf gives 0 and a finite Q; one "
          f"full-width step = {len(products)} products, {nbytes} B, {flops} flop: "
          f"kernel_ms {kernel_ms:.4f}  bound_ms {bound_ms:.4f} (bytes at 3.35 "
          f"TB/s; flops at 67 TFLOP/s f32 {flops_ms:.4f}; {bound_ms / kernel_ms:.1%} "
          f"of the HBM rate)  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f} "
          f"(torch.bmm, TF32 off)  tiled kernel {tiled_ms:.4f}  kernel wall ms "
          f"with host dispatch {kernel_wall_ms:.4f}", flush=True)
    return {
        "name": MATMUL,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lowrank_matmul.cu",
        "replaces": "src/repro/kernels/lowrank.py:40",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": library_ms,
        "library_call": "torch.bmm on the same (transposed) views, TF32 off",
        "timed_work": f"{len(products)} products of one full-width PowerSGD step",
        "wall_ms": kernel_wall_ms,
        "ms_by_product": by_kind,
        "ms_by_route": {r: by_kind[kind] for kind, r in kinds.items()},
        "tiled_ms": tiled_ms,
        "launch_fit_by_route": fits,
        "tiled_ms_by_product": tiled_by_kind,
        "max_err_over_abs_product": worst,
    }


def phase_threshold_kernels() -> dict:
    """``threshold_filter`` against ``threshold_filter_ref`` bit for bit in y
    and the counts: ragged, t = 0 (padding never counted), NaN and +-inf,
    an offset-1 view, the largest bucket; then over one full-width step's 35
    buckets at ``sample_threshold`` ratios 0.01 and 0.001, timed."""
    from repro_torch.kernels.ref import sample_threshold, threshold_filter_ref
    from repro_torch.kernels.topk_threshold import threshold_filter

    plan, bufs, total = full_width_buckets()
    largest = max(bufs, key=lambda x: x.numel())
    gen = torch.Generator("cuda").manual_seed(8)
    # (name, n, view offset, threshold: a ratio for sample_threshold or a value,
    #  block, special values)
    cases = [
        ("ragged", 1_000_003, 0, 0.01, THRESHOLD_BLOCK, False),
        ("zero-threshold-ragged", 70_001, 0, 0.0, THRESHOLD_BLOCK, True),
        ("zero-threshold-block-4096", 5000, 0, 0.0, 4096, True),
        ("nan-inf", 100_003, 0, 0.5, THRESHOLD_BLOCK, True),
        ("offset-1", 100_003, 1, 0.01, THRESHOLD_BLOCK, True),
        ("largest-bucket", largest.numel(), 0, 0.001, THRESHOLD_BLOCK, False),
    ]
    for name, n, off, thr, block, special in cases:
        x = (largest.clone() if name == "largest-bucket"
             else torch.randn(n + off, generator=gen, device="cuda")[off:])
        if special:
            x[:6] = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0,
                                  0.0, 1e-45], device="cuda")
        t = (sample_threshold(x, thr) if 0 < thr < 0.1
             else torch.tensor(thr, device="cuda"))
        y, c = threshold_filter(x, t, block=block)
        ry, rc = threshold_filter_ref(x, t, block)
        torch.cuda.synchronize()
        check(torch.equal(y.view(torch.int32), ry.view(torch.int32)),
              f"threshold_filter {name}: y not bitwise equal to threshold_filter_ref")
        check(torch.equal(c, rc), f"threshold_filter {name}: counts {c[:4].tolist()} "
              f"vs {rc[:4].tolist()}")
        if thr == 0.0:
            want_last = n - (c.numel() - 1) * block
            check(int(c[-1]) == want_last and int(c.sum()) == n - 1,
                  f"threshold_filter {name}: counts {c.tolist()[-3:]} at t = 0 "
                  f"(padding counted, or the NaN)")

    times, bounds, kept = {}, {}, {}
    nb_total = sum(-(-x.numel() // THRESHOLD_BLOCK) for x in bufs)
    bound_ms = (8 * total + 4 * nb_total + 4 * len(bufs)) / HBM_BYTES_PER_S * 1e3
    for ratio in (0.01, 0.001):
        ts = [sample_threshold(x, ratio) for x in bufs]
        times[ratio] = device_timed(lambda ts=ts: [
            threshold_filter(x, t) for x, t in zip(bufs, ts)])
        times[f"{ratio}_plain"] = device_timed(lambda ts=ts: [
            threshold_filter_ref(x, t, THRESHOLD_BLOCK) for x, t in zip(bufs, ts)])
        kept[ratio] = sum(int(threshold_filter(x, t)[1].sum())
                          for x, t in zip(bufs, ts)) / total
    wall = wall_timed(lambda: [threshold_filter(x, t) for x, t in zip(bufs, ts)])
    work = f"{len(bufs)} buckets, {total} elements (one full-width step)"
    for ratio in (0.01, 0.001):
        print(f"[kernels] threshold_filter at sample_threshold ratio {ratio} "
              f"(kept {kept[ratio]:.5f} of the elements): {work}: kernel_ms "
              f"{times[ratio]:.4f}  bound_ms {bound_ms:.4f} ({bound_ms / times[ratio]:.1%} "
              f"of the HBM rate)  plain_ms {times[f'{ratio}_plain']:.4f}  library_ms "
              f"none (no single PyTorch call gives y and the counts)", flush=True)
    print(f"[kernels] threshold_filter bitwise equal to threshold_filter_ref in y "
          f"and counts on {len(cases)} cases; kernel wall ms with host dispatch "
          f"(ratio 0.001) {wall:.4f}", flush=True)
    return {
        "name": "threshold_filter",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/threshold_filter.cu",
        "replaces": "src/repro/kernels/topk_threshold.py:27",
        "launches": 0,
        "path": None,
        "path_note": "on no train path: behind repro_torch.kernels.ops only, as the "
                     "reference's kernel is behind repro.kernels.ops",
        "max_abs_err": 0.0,
        "ms": times[0.01],
        "plain_ms": times["0.01_plain"],
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "library_call": "none: no single PyTorch call gives y and the counts",
        "timed_work": work + ", sample_threshold ratio 0.01",
        "ms_ratio_0.001": times[0.001],
        "plain_ms_ratio_0.001": times["0.001_plain"],
        "wall_ms": wall,
    }


def phase_adamw() -> None:
    """One AdamW update, as the main path's optimizer makes it, on the card
    and on the CPU from the same moments, gradients and params (leaves of
    full-width shapes): m, v and the bias-corrected divisions bit for bit;
    ``torch.sqrt`` in float32, which may differ by one ulp between the two
    (``ROADMAP.md`` queue 3), held at 1 ulp, each against the correctly
    rounded root; the update bit for bit where the roots agree, elsewhere
    within 4 ulps of ``lr * m_hat / (sqrt(v_hat) + eps)``."""
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.optim.optimizers import bias_corrections

    gen = torch.Generator().manual_seed(9)
    shapes = [(12, 768, 3072), (768, 50304), (12, 768), (768,)]
    g, m, p = ([torch.randn(s, generator=gen) for s in shapes] for _ in range(3))
    v = [torch.rand(s, generator=gen) * 1e-3 for s in shapes]
    step, lr_fn = 3, cosine_warmup(1.5e-4, STEPS // 10 + 1, STEPS)
    opt = adamw(lr_fn)
    out = {}
    for dev in ("cpu", "cuda"):
        on = lambda xs: [x.to(dev) for x in xs]   # noqa: E731
        upd, new = opt.update(on(g), {"step": step, "m": on(m), "v": on(v)}, on(p))
        out[dev] = [[x.cpu() for x in part] for part in (upd, new["m"], new["v"])]
    (u_gpu, m_gpu, v_gpu), (u_cpu, m_cpu, v_cpu) = out["cuda"], out["cpu"]
    check(all(torch.equal(a, b) for a, b in zip(m_gpu + v_gpu, m_cpu + v_cpu)),
          "adamw: m or v differ between the card and the CPU")
    bc1, bc2 = bias_corrections(step + 1, 0.9, 0.999, torch.device("cpu"))
    lr = float(lr_fn(step + 1))
    n = off = off_cpu = off_gpu = bitwise = 0
    worst = 0.0
    for ug, uc, mm, vv in zip(u_gpu, u_cpu, m_cpu, v_cpu):
        vh = vv / bc2
        check(torch.equal((mm / bc1), (mm.cuda() / bc1.cuda()).cpu()),
              "adamw: m / bc1 differs between the card and the CPU")
        root_cpu, root_gpu = torch.sqrt(vh), torch.sqrt(vh.cuda()).cpu()
        exact = torch.sqrt(vh.double()).float()
        ulps = (root_cpu.view(torch.int32).long() - root_gpu.view(torch.int32).long()).abs()
        check(int(ulps.max()) <= 1, f"adamw: sqrt differs by {int(ulps.max())} ulps")
        agree = ulps == 0
        check(torch.equal(ug[agree], uc[agree]),
              "adamw: the update differs where the square roots agree")
        term = (lr * (mm / bc1) / (root_cpu + 1e-8)).abs()
        diff = (ug - uc).abs()
        check(bool((diff <= 2.0 ** -21 * term).all()),
              "adamw: the update differs by more than 4 ulps of lr * m_hat / denominator")
        n += vh.numel()
        off += int((~agree).sum())
        off_cpu += int((root_cpu != exact).sum())
        off_gpu += int((root_gpu != exact).sum())
        bitwise += int((ug == uc).sum())
        worst = max(worst, float((diff / term.clamp_min(1e-30)).max()))
    print(f"[adamw] one update (step {step + 1}, lr {lr:.6g}) of {n} elements on the "
          f"card vs the CPU: m, v and m / bc1 bitwise; torch.sqrt differs by 1 ulp on "
          f"{off} elements ({off / n:.4%}; the CPU's root is not the correctly rounded "
          f"one on {off_cpu}, the card's on {off_gpu}); the update bitwise on {bitwise} "
          f"elements ({bitwise / n:.4%}), elsewhere within {worst * 2 ** 23:.3g} ulps of "
          f"lr * m_hat / denominator (held at 4)", flush=True)


def gather_order(tr) -> str:
    """The last sharded step's head all-gather, from the trainer's events:
    the issue order, then the buckets settled before each layer (``E`` the
    embedding, ``L<i>`` layer i, ``H`` the final norm and head).  Checks
    that every issue precedes layer 0, issues follow the first use, and each
    bucket is settled just before the stage that first reads it."""
    from repro_torch.core.overlap import EMBED_STAGE, bucket_first_use

    L = tr.model.cfg.num_layers
    stages = bucket_first_use(tr.plan, L)
    events = tr.gather_events
    issues = [i for k, i in events if k == "issue"]
    check(issues == sorted(range(len(stages)), key=lambda b: (stages[b], b)),
          f"sharded: gathers issued in the order {issues}")
    check(events[:len(issues)] == [("issue", b) for b in issues],
          "sharded: a gather was issued after the forward pass began")
    parts, pending, seen = [], [], []
    for k, i in events[len(issues):]:
        if k == "settle":
            pending.append(i)
            continue
        want = sorted(b for b, f in enumerate(stages)
                      if f == i or (i == 0 and f == EMBED_STAGE))
        check(sorted(pending) == want, f"sharded: settled {pending} before stage "
              f"{i}, want {want}")
        if i == 0:
            embed = [b for b in pending if stages[b] == EMBED_STAGE]
            check(pending[:len(embed)] == embed, "sharded: the embedding's buckets "
                  "were not settled first")
            parts.append(f"E<-{embed}")
            pending = pending[len(embed):]
        parts.append(f"{'H' if i == L else f'L{i}'}<-{pending}")
        seen.append(i)
        pending = []
    check(seen == list(range(L + 1)) and not pending,
          f"sharded: stages {seen}, buckets left {pending}")
    return f"issue {issues}; settle " + " ".join(parts)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def clone_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(clone_tree(v) for v in x)
    return x


def ckpt_batches(cfg, seq_len=1024, global_batch=8, device="cuda") -> list[dict]:
    """The first 5 batches of :func:`phase_train`'s loader: the checkpoint
    and re-plan phases feed each run the same list."""
    from repro_torch.data import DataConfig, make_loader

    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                    global_batch=global_batch), device=device)
    return [loader.make(s) for s in range(STEPS)]


def phase_train(cfg, *, device="cuda", seq_len=1024, global_batch=8,
                group=None, label="defaults", options=None):
    """Full-width training through ``Trainer.run`` on the ``TrainConfig``
    defaults updated with ``options``.  Returns the trainer, its state and
    the loader, and the launches of each kernel in the run
    (``{"ef_update": n, "pack_ef_cast": m, ...}``, every kernel).  The
    trainer's ``run_stats`` holds steps 1-4's ms, tok/s after step 0 and
    the peak GiB."""
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train import TrainConfig, Trainer

    base = 0.0
    if device != "cpu":
        # earlier runs' trainers sit in reference cycles until a collection:
        # free them, so that each run's peak counts its own memory
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated() / 2**30
    model = build_model(cfg, device=device, seed=0)
    opt = adamw(cosine_warmup(1.5e-4, STEPS // 10 + 1, STEPS))
    tc = TrainConfig(steps=STEPS, log_every=1)
    check((tc.compressor, tc.interval, tc.overlap, tc.arena, tc.sync)
          == ("covap", 4, "post", False, "allreduce"),
          f"TrainConfig defaults moved: {tc}")
    tc = TrainConfig(steps=STEPS, log_every=1, **(options or {}))
    tr = Trainer(model, opt, tc, group=group)
    state = tr.init_state()
    n_params = sum(p.numel() for p in state["params"])
    loader = make_loader(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                   global_batch=global_batch),
        device=device,
    )
    lines: list[str] = []
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    by_route = counters[MATMUL].launches_by_route
    by_route.update(dict.fromkeys(by_route, 0))
    state = tr.run(state, loader, steps=STEPS, log=lines.append)
    launches = {name: fn.launches for name, fn in counters.items()}
    if device != "cpu":
        torch.cuda.synchronize()

    hist = tr.history
    losses = [h["loss"] for h in hist]
    check(len(hist) == STEPS, f"expected {STEPS} logged steps, got {len(hist)}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in state["params"]),
          "non-finite parameters after training")
    step_ms = [1e3 * (b["wall_s"] - a["wall_s"]) for a, b in zip(hist, hist[1:])]
    tok_s = (STEPS - 1) * global_batch * seq_len / (hist[-1]["wall_s"] - hist[0]["wall_s"])
    peak = torch.cuda.max_memory_allocated() / 2**30 if device != "cpu" else 0.0
    wire = tc.compressor_options.get("wire_dtype") or "f32"
    tr.run_stats = (step_ms, tok_s, peak)
    print(f"[train] {label}: {cfg.name} {n_params} params, {tr.plan.num_buckets} "
          f"buckets / {tr.plan.num_segments} segments, {tc.compressor} "
          f"{tr.num_phases} phase(s) {tc.overlap} {tc.sync} "
          f"arena={'on' if tc.arena else 'off'} "
          f"wire={wire}, adamw, seq {seq_len} x batch {global_batch}, world "
          f"{tr.dp_world}: losses {[round(v, 4) for v in losses]}  step 0 "
          f"{1e3 * hist[0]['wall_s']:.1f} ms, steps 1-{STEPS - 1} ms "
          f"{[round(v, 2) for v in step_ms]}  {tok_s:.0f} tok/s after step 0  "
          f"peak {peak:.2f} GiB (of which {base:.2f} GiB held before the "
          f"run)  launches {launches}", flush=True)
    if tr.gather_events:
        print(f"[train] {label}: head all-gather of step {STEPS}, by bucket: "
              f"{gather_order(tr)}", flush=True)
    return tr, state, loader, launches


def phase_parity(tr, state, loader, group) -> None:
    """One step from the trained state on the same gradients, through
    ``build_step_fn(...).update`` for each execution form."""
    from repro_torch.core import get_compressor
    from repro_torch.core.overlap import sharded_param_allgather
    from repro_torch.kernels.ef_covap import ef_update
    from repro_torch.kernels.pack_ef_cast import pack_ef_cast
    from repro_torch.train import build_step_fn, loss_and_grads

    batch = loader.make(state["step"])
    phase = state["step"] % tr.num_phases
    grads, _ = loss_and_grads(tr.model, state["params"], batch, group)
    bf16 = {"wire_dtype": "bfloat16"}
    forms = {
        "ef-kernel": {},
        "ef-plain": {"use_ef_kernel": False},
        "arena": {"use_arena": True},
        "arena-plain": {"use_arena": True, "use_pack_kernel": False},
        "bf16": bf16,
        "arena-bf16": {"use_arena": True, **bf16},
        "arena-bf16-plain": {"use_arena": True, "use_pack_kernel": False, **bf16},
        "sharded": {"sync": "sharded"},
    }
    out, launches = {}, {}
    for name, opts in forms.items():
        comp = get_compressor("covap", interval=tr.tc.interval, **opts)
        fn = build_step_fn(tr.model, tr.optimizer, comp, tr.plan, phase=phase,
                           group=group)
        new_state = clone_tree(state)
        if name == "sharded":
            # the head all-gather of a one-rank group: launched, and an
            # identity on the values
            before = [p.clone() for p in new_state["params"]]
            sharded_param_allgather(comp, fn.comm_schedule, new_state["params"],
                                    group=group)
            check(all(torch.equal(a, b) for a, b in zip(before, new_state["params"])),
                  "parity: the one-rank head all-gather changed the params")
            del before
        e0, p0 = ef_update.launches, pack_ef_cast.launches
        new_state, _ = fn.update(new_state, grads)
        torch.cuda.synchronize()
        launches[name] = (ef_update.launches - e0, pack_ef_cast.launches - p0)
        out[name] = new_state["params"] + new_state["comp"]
        del new_state
    n = tr.plan.num_segments
    want = {"ef-kernel": (n, 0), "arena": (0, n), "arena-bf16": (0, n),
            "sharded": (0, n)}
    for name, got in launches.items():
        check(got == want.get(name, (0, 0)),
              f"parity: {name} launched (ef_update, pack_ef_cast) = {got}")
    c = get_compressor("covap", interval=tr.tc.interval).ef_coefficient(state["step"])
    worst = 0.0
    for a, b, r in zip(out["ef-kernel"], out["ef-plain"],
                       state["comp"] + state["comp"]):
        check(ef_close(a, b, r, c), "parity: ef_update kernel and plain disagree")
        worst = max(worst, abs_err(a, b))
    pairs = [("arena", "ef-kernel"), ("arena-plain", "arena"),
             ("arena-bf16", "bf16"), ("arena-bf16-plain", "arena-bf16"),
             ("sharded", "ef-kernel")]
    for a, b in pairs:
        diff = max(abs_err(x, y) for x, y in zip(out[a], out[b]))
        check(all(torch.equal(x, y) for x, y in zip(out[a], out[b])),
              f"parity: {a} != {b} in params or EF residuals (max |diff| {diff})")
    print(f"[parity] step {state['step']} (phase {phase}), same gradients: "
          f"ef_update kernel vs use_ef_kernel=False agree (max |diff| "
          f"{worst:.3g}); bitwise equal in params and EF residuals: "
          f"{', '.join(f'{a} == {b}' for a, b in pairs)}; launches "
          f"(ef_update, pack_ef_cast) {launches}", flush=True)


def phase_flat_parity(tr, state, loader, group) -> None:
    """One step of the flat-bucket path from the trained state on the same
    gradients, through ``SyncPipeline.execute``: the CUDA kernels against
    ``use_wire_kernel=False`` and the arena against the per-bucket form."""
    from repro_torch.core import get_compressor
    from repro_torch.core.comm import world_size
    from repro_torch.train import loss_and_grads

    name = tr.tc.compressor
    batch = loader.make(state["step"])
    grads, _ = loss_and_grads(tr.model, state["params"], batch, group)
    forms = {
        "kernel": {},
        "plain": {"use_wire_kernel": False},
        "arena": {"use_arena": True},
        "arena-plain": {"use_arena": True, "use_wire_kernel": False},
    }
    counters = kernel_counters()
    out, launches = {}, {}
    for form, opts in forms.items():
        comp = get_compressor(name, **opts)
        sched = comp.plan_phase(tr.plan, 0, world=world_size(group))
        before = {k: f.launches for k, f in counters.items()}
        synced, resid, _ = comp.execute(sched, grads, state["comp"],
                                        step=state["step"], group=group)
        torch.cuda.synchronize()
        launches[form] = {k: f.launches - before[k] for k, f in counters.items()
                          if f.launches != before[k]}
        out[form] = (synced, resid)
    nb = tr.plan.num_buckets
    kernel = ({"quantize_fp8": nb, "dequantize_fp8": 2 * nb} if name == "fp8wire"
              else {"sign_compress": nb})
    want = {"kernel": kernel, "arena": kernel, "plain": {}, "arena-plain": {}}
    check(launches == want, f"flat parity {name}: launches {launches}, want {want}")
    for a, b in (("arena", "kernel"), ("arena-plain", "plain")):
        diff = max(abs_err(x, y) for x, y in zip(out[a][0] + out[a][1],
                                                 out[b][0] + out[b][1]))
        check(all(torch.equal(x, y) for x, y in zip(out[a][0] + out[a][1],
                                                    out[b][0] + out[b][1])),
              f"flat parity {name}: {a} != {b} (max |diff| {diff})")
    (ks, kr), (ps, pr) = out["kernel"], out["plain"]
    worst = max(abs_err(x, y) for x, y in zip(ks + kr, ps + pr))
    if name == "fp8wire":
        check(all(torch.equal(x, y) for x, y in zip(ks + kr, ps + pr)),
              f"flat parity fp8wire: kernels != plain (max |diff| {worst})")
        how = "bit for bit in synced grads and EF residuals"
    else:
        check(all(torch.equal(torch.sign(x), torch.sign(y)) for x, y in zip(ks, ps)),
              "flat parity efsignsgd: the kernel's signs differ from the plain ones")
        for x, y in zip(ks, ps):
            check(torch.allclose(x, y, rtol=1e-6, atol=0),
                  "flat parity efsignsgd: synced values beyond rtol 1e-6")
        for x, y, o in zip(kr, pr, ps):
            atol = 1e-6 * float(o.abs().max())
            check(torch.allclose(x, y, rtol=1e-6, atol=atol),
                  "flat parity efsignsgd: residuals beyond rtol 1e-6, atol 1e-6 "
                  f"of the scale (max |diff| {abs_err(x, y)})")
        how = ("signs bit for bit, synced values at rtol 1e-6, residuals at rtol "
               "1e-6 and atol 1e-6 of the leaf's largest synced value")
    print(f"[parity] {name} step {state['step']}, same gradients: kernels vs "
          f"use_wire_kernel=False {how} (max |diff| {worst:.3g}); arena == "
          f"per-bucket and arena-plain == plain bit for bit; launches {launches}",
          flush=True)


def sign_aligned(q: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``q`` with each column (last axis) of each batch multiplied by the
    sign that best matches ``ref``'s: QR's column signs may differ between
    two runs whose P differ in their last bits."""
    s = torch.sign((q * ref).sum(dim=-2, keepdim=True))
    return q * torch.where(s == 0, torch.ones_like(s), s)


def leaf_close(got: torch.Tensor, want: torch.Tensor, scale: float) -> bool:
    """rtol 1e-4, atol 1e-5 of ``scale``."""
    return torch.allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def phase_powersgd_parity(tr, state, loader, group) -> None:
    """One PowerSGD step from the trained state on the same gradients,
    through ``SyncPipeline.execute``: the ``lowrank.matmul`` kernel against
    ``use_wire_kernel=False`` (``torch.matmul``).  Synced values (``approx``)
    at rtol 1e-4, atol 1e-5 of the leaf's largest; residuals likewise,
    against the leaf's largest ``approx``; Q up to the sign of each column,
    at rtol 1e-4, atol 1e-5 of its largest."""
    from repro_torch.core import get_compressor
    from repro_torch.core.comm import world_size
    from repro_torch.train import loss_and_grads

    batch = loader.make(state["step"])
    grads, _ = loss_and_grads(tr.model, state["params"], batch, group)
    counters = kernel_counters()
    out, launches = {}, {}
    for form, opts in (("kernel", {}), ("plain", {"use_wire_kernel": False})):
        comp = get_compressor("powersgd", **opts)
        sched = comp.plan_phase(tr.plan, 0, world=world_size(group))
        before = {k: f.launches for k, f in counters.items()}
        synced, new, _ = comp.execute(sched, grads, state["comp"], step=state["step"],
                                      group=group)
        torch.cuda.synchronize()
        launches[form] = {k: f.launches - before[k] for k, f in counters.items()
                          if f.launches != before[k]}
        out[form] = (synced, new)
    n = 3 * len(lowrank_leaves(tr.plan))
    check(launches == {"kernel": {MATMUL: n}, "plain": {}},
          f"powersgd parity: launches {launches}, want {MATMUL} {n} and 0")
    (ks, kn), (ps, pn) = out["kernel"], out["plain"]
    worst = {"approx": 0.0, "residual": 0.0, "q": 0.0}
    for i, (a, b) in enumerate(zip(ks, ps)):
        scale = float(b.abs().max())
        worst["approx"] = max(worst["approx"], abs_err(a, b) / max(scale, 1e-30))
        check(bool(torch.isfinite(a).all()) and leaf_close(a, b, scale),
              f"powersgd parity: leaf {i} approx, kernel vs plain, max |diff| "
              f"{abs_err(a, b):.3g} of {scale:.3g}")
        ra, rb = kn["residual"][i], pn["residual"][i]
        worst["residual"] = max(worst["residual"], abs_err(ra, rb) / max(scale, 1e-30))
        check(leaf_close(ra, rb, scale), f"powersgd parity: leaf {i} residual, max "
              f"|diff| {abs_err(ra, rb):.3g} against approx's {scale:.3g}")
        qa, qb = kn["q"][i], pn["q"][i]
        if qb is None:
            check(qa is None, f"powersgd parity: leaf {i} has a Q in one form only")
            continue
        qa = sign_aligned(qa, qb)
        qscale = float(qb.abs().max())
        worst["q"] = max(worst["q"], abs_err(qa, qb) / max(qscale, 1e-30))
        check(leaf_close(qa, qb, qscale), f"powersgd parity: leaf {i} Q up to column "
              f"sign, max |diff| {abs_err(qa, qb):.3g} of {qscale:.3g}")
    print(f"[parity] powersgd step {state['step']}, same gradients: lowrank.matmul "
          f"kernel vs use_wire_kernel=False: approx, residuals and Q (up to column "
          f"sign) within rtol 1e-4, atol 1e-5 of the leaf's largest (largest "
          f"|diff| / scale: { {k: float(f'{v:.3g}') for k, v in worst.items()} }); "
          f"launches {launches}", flush=True)


def ordered_ints(x: torch.Tensor) -> torch.Tensor:
    """float32 bits as integers in the order of the values (-0 and +0 both
    0), so that a difference counts ulps."""
    i = x.float().contiguous().view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def check_same_leaves(what: str, got, want) -> int:
    """``torch.equal`` leaf by leaf; where a leaf differs, print it and its
    largest ulp distance, held at ``FUSED_PARITY_ULPS``.  -> the largest."""
    worst = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if torch.equal(a, b):
            continue
        ulps = int((ordered_ints(a) - ordered_ints(b)).abs().max())
        print(f"[parity] fused: {what} leaf {i} differs by up to {ulps} ulp(s)",
              flush=True)
        check(ulps <= FUSED_PARITY_ULPS, f"parity fused: {what} leaf {i}: {ulps} "
              f"ulps beyond the bound of {FUSED_PARITY_ULPS}")
        worst = max(worst, ulps)
    check(len(got) == len(want), f"parity fused: {what}: {len(got)} leaves, "
          f"want {len(want)}")
    return worst


def check_fused_run(tr, label: str) -> str:
    """The last fused step's records: every hook's backward ran on the
    stream the forward pass ran on, and the hooks fired in
    ``ReadyOrder.order()`` up to ties of equal ``bucket_layer``."""
    from repro_torch.core import build_ready_order

    fwd, streams = tr.last_step_fn.hook_streams
    check(streams and all(x == fwd for x in streams),
          f"{label}: hook streams {sorted(set(streams))}, forward stream {fwd}")
    fired = list(tr.last_step_fn.fired)
    check_ready_order(fired, tr.plan, label)
    return (f"{len(fired)} hooks on the forward's stream {fwd}; fired in "
            f"ReadyOrder up to ties (first {fired[:6]}, last {fired[-3:]}), "
            f"ReadyOrder {list(build_ready_order(tr.plan).order[:6])}...")


def check_ready_order(order, plan, what: str) -> None:
    from repro_torch.core import build_ready_order

    ready = build_ready_order(plan)
    check(sorted(order) == list(range(plan.num_buckets)),
          f"{what}: buckets {order} are not each bucket once")
    layers = [ready.bucket_layer[b] for b in order]
    check(layers == sorted(layers, reverse=True),
          f"{what}: bucket layers {layers} not in ReadyOrder")


def phase_fused_parity(tr, state, loader, group) -> None:
    """From one state and one batch, each fused form against its post form
    (``torch.equal``): the synced gradients and residuals of
    ``overlapped_loss_and_grads`` against ``loss_and_grads`` +
    ``execute``, then the params, Adam moments and residuals after one step
    of ``build_overlapped_step`` against ``build_step_fn(...).update``."""
    from repro_torch.core import get_compressor
    from repro_torch.core.overlap import overlapped_loss_and_grads
    from repro_torch.kernels.ef_covap import ef_update
    from repro_torch.kernels.pack_ef_cast import pack_ef_cast
    from repro_torch.train import build_overlapped_step, build_step_fn, loss_and_grads

    batch = loader.make(state["step"])
    phase = state["step"] % tr.num_phases
    forms = {"defaults": {}, "arena": {"use_arena": True},
             "sharded": {"sync": "sharded"}}
    n = tr.plan.num_segments
    notes = []
    worst = 0
    for name, opts in forms.items():
        comp = get_compressor("covap", interval=tr.tc.interval, **opts)
        post = build_step_fn(tr.model, tr.optimizer, comp, tr.plan, phase=phase,
                             group=group)
        fused = build_overlapped_step(tr.model, tr.optimizer, comp, tr.plan,
                                      phase=phase, group=group)
        sched = post.comm_schedule
        grads, _ = loss_and_grads(tr.model, state["params"], batch, group)
        want = comp.execute(sched, grads, state["comp"], step=state["step"],
                            group=group)[:2]
        del grads
        e0, p0 = ef_update.launches, pack_ef_cast.launches
        got = overlapped_loss_and_grads(tr.model, comp, sched, state["params"],
                                        state["comp"], batch, state["step"],
                                        group=group)[2:4]
        torch.cuda.synchronize()
        launched = (ef_update.launches - e0, pack_ef_cast.launches - p0)
        check(launched == ((n, 0) if name == "defaults" else (0, n)),
              f"parity fused {name}: launched (ef_update, pack_ef_cast) {launched}")
        worst = max(worst, check_same_leaves(f"{name} synced", got[0], want[0]),
                    check_same_leaves(f"{name} residuals", got[1], want[1]))
        del got, want
        grads, _ = loss_and_grads(tr.model, state["params"], batch, group)
        sp, _ = post.update(clone_tree(state), grads)
        del grads
        sf, _ = fused(clone_tree(state), batch)
        torch.cuda.synchronize()
        for part, a, b in (("params", sf["params"], sp["params"]),
                           ("adam m", sf["opt"]["m"], sp["opt"]["m"]),
                           ("adam v", sf["opt"]["v"], sp["opt"]["v"]),
                           ("residuals", sf["comp"], sp["comp"])):
            worst = max(worst, check_same_leaves(f"{name} updated {part}", a, b))
        notes.append(name)
        del sp, sf
        torch.cuda.empty_cache()
    print(f"[parity] fused step {state['step']} (phase {phase}), one state and one "
          f"batch: {', '.join(notes)}: fused == post in synced gradients, "
          f"residuals, and the params, Adam moments and residuals after the step "
          f"(largest ulp distance {worst}, bound {FUSED_PARITY_ULPS})", flush=True)


def _bucket_of_span(name: str) -> int:
    return int(name.split("/")[0].removeprefix("covap_bucket_"))


def overlap_counts(prof, plan, issue_order) -> tuple[list[int], int, int]:
    """From one profiled step: the host order of the ``covap_bucket_*``
    spans, and how many buckets' ``ef_update`` kernels start on the device
    before the step's last GEMM (layer 0's last backward GEMM: nothing
    after layer 0's backward runs a matrix product), out of how many.
    ``issue_order`` is the order the buckets' kernels were launched in."""
    from repro_torch.launch.profile_train import kernel_group

    # the CPU side of each span (the profiler also records its device range)
    spans = sorted((e for e in prof.events() if e.name.startswith("covap_bucket_")
                    and e.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda e: e.time_range.start)
    host = [_bucket_of_span(e.name) for e in spans]
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    check(bool(kernels), "overlap: the profiler recorded no device events")
    gemms = [e for e in kernels if kernel_group(e.name) == "matmul"]
    check(bool(gemms), "overlap: no matrix product in the trace")
    efs = [e for e in kernels if kernel_group(e.name) == "ef_update"]
    owners = [b for b in issue_order for _ in plan.buckets[b].segments]
    check(len(efs) == len(owners), f"overlap: {len(efs)} ef_update kernels in the "
          f"trace, {len(owners)} segments")
    last_gemm = gemms[-1].time_range.start
    early = {b for b, e in zip(owners, efs) if e.time_range.start < last_gemm}
    return host, len(early), len(set(owners))


def phase_overlap(tr, state, loader, group) -> None:
    """One post step and one fused step of the defaults form under
    ``torch.profiler``: the fused step's host order of its
    ``covap_bucket_*`` spans must follow ``ReadyOrder`` up to ties, and at
    least one bucket's ``ef_update`` kernels must start on the device before
    layer 0's last backward GEMM; under post none may.  With one card this
    shows where each bucket is issued, not overlap across cards."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import build_ready_order
    from repro_torch.train import build_step_fn

    phase = state["step"] % tr.num_phases
    post = build_step_fn(tr.model, tr.optimizer, tr.compressor, tr.plan, phase=phase,
                         group=group)
    out = {}
    for overlap in ("post", "fused"):
        batch = loader.make(state["step"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if overlap == "post":
                state, _ = post(state, batch)
            else:
                state, _ = tr.step(state, batch)
            torch.cuda.synchronize()
        order = (list(range(tr.plan.num_buckets)) if overlap == "post"
                 else list(tr.last_step_fn.fired))
        out[overlap] = overlap_counts(prof, tr.plan, order)
    host, early, total = out["fused"]
    check(host == list(tr.last_step_fn.fired), "overlap: the covap_bucket spans "
          f"{host} differ from the hooks' firing order {tr.last_step_fn.fired}")
    check_ready_order(host, tr.plan, "overlap: covap_bucket spans")
    check(not out["post"][0], "overlap: the post step recorded covap_bucket spans")
    check(early >= 1, f"overlap: no fused bucket started before layer 0's last GEMM")
    check(out["post"][1] == 0, f"overlap: {out['post'][1]} post buckets started "
          "before layer 0's last GEMM")
    ready = build_ready_order(tr.plan)
    print(f"[overlap] one full-width step each, one card: fused covap_bucket spans "
          f"in host order {host} (ReadyOrder {list(ready.order)}, equal up to ties "
          f"of equal bucket_layer); buckets whose ef_update kernels start on the "
          f"device before layer 0's last backward GEMM: fused {early} of {total}, "
          f"post {out['post'][1]} of {out['post'][2]}.  One card and a one-rank "
          f"group: this shows where each bucket is issued, not overlap across "
          f"cards", flush=True)


def comp_parts(comp) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """A compressor state as ``(residual-like leaves, PowerSGD's Qs)``: the
    residual list of the segmented and flat paths (no Q), or PowerSGD's
    residuals and Qs without the ``None`` entries."""
    if isinstance(comp, dict):
        return ([r for r in comp["residual"] if r is not None],
                [q for q in comp["q"] if q is not None])
    return list(comp), []


def fresh_trainer(cfg, group, options=None, device="cuda"):
    """A trainer as :func:`phase_train` builds it (the model from seed 0,
    AdamW on the same schedule), and its fresh state."""
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train import TrainConfig, Trainer

    model = build_model(cfg, device=device, seed=0)
    opt = adamw(cosine_warmup(1.5e-4, STEPS // 10 + 1, STEPS))
    tr = Trainer(model, opt, TrainConfig(steps=STEPS, log_every=1, **(options or {})),
                 group=group)
    return tr, tr.init_state()


def zero_counters() -> dict:
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    by_route = counters[MATMUL].launches_by_route
    by_route.update(dict.fromkeys(by_route, 0))
    return counters


def state_parts(state) -> dict:
    """A train state's tensors by part, cloned: params, Adam's m and v, the
    residuals (PowerSGD's without its ``None`` holes) and PowerSGD's Qs."""
    resid, qs = comp_parts(state["comp"])
    return {part: [x.detach().clone() for x in leaves] for part, leaves in (
        ("params", state["params"]), ("m", state["opt"]["m"]),
        ("v", state["opt"]["v"]), ("residual", resid), ("q", qs))}


def phase_ckpt(cfg, group, label: str, options: dict, batches) -> dict:
    """Save and resume at full width: 2 steps, ``save_train_state`` into a
    temporary directory, 3 more steps (state A); a fresh trainer, then
    ``restore_train_state`` and the same 3 batches (state B).  A equals B
    bit for bit in params, Adam's m and v, the residuals (and PowerSGD's
    Q), both steps and the losses.  Prints the bytes on disk and the save,
    digest and restore seconds; a copy of the checkpoint with one byte
    flipped must raise ``CheckpointCorruptError``.  The directory is
    deleted afterwards.  -> the launches of the run's 8 steps."""
    import os
    import shutil
    import tempfile

    from repro_torch import checkpoint

    gc.collect()
    torch.cuda.empty_cache()
    counters = zero_counters()
    device = batches[0]["tokens"].device
    tr, state = fresh_trainer(cfg, group, options, device)
    state = tr.run(state, iter(batches[:2]), steps=2, log=None)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = checkpoint.save_train_state(tmp, state, interval=tr.tc.interval,
                                        names=tr.leaf_names, group=group)
        save_s = time.perf_counter() - t0
        nbytes = {f: os.path.getsize(os.path.join(d, f)) for f in sorted(os.listdir(d))}
        t0 = time.perf_counter()
        digest = checkpoint.verify(tmp, 2)
        digest_s = time.perf_counter() - t0
        state = tr.run(state, iter(batches[2:]), steps=3, log=None)
        want, want_steps = state_parts(state), (state["step"], state["opt"]["step"])
        want_losses = [h["loss"] for h in tr.history[2:]]
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()

        tr, state = fresh_trainer(cfg, group, options, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, extra = checkpoint.restore_train_state(tmp, state, names=tr.leaf_names,
                                                      group=group)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(extra["comp_restored"] and extra["world"] == 1 and state["step"] == 2,
              f"ckpt {label}: restore gave step {state['step']}, extra {extra}")
        state = tr.run(state, iter(batches[2:]), steps=3, log=None)
        got, got_steps = state_parts(state), (state["step"], state["opt"]["step"])
        losses = [h["loss"] for h in tr.history]
        check(got_steps == want_steps == (5, 5),
              f"ckpt {label}: steps {got_steps} after resume, {want_steps} uninterrupted")
        check(losses == want_losses and all(math.isfinite(v) for v in losses),
              f"ckpt {label}: losses {losses} after resume, {want_losses} uninterrupted")
        for part in want:
            check(len(got[part]) == len(want[part])
                  and all(torch.equal(a, b) for a, b in zip(got[part], want[part])),
                  f"ckpt {label}: {part} differs between the resumed and the "
                  "uninterrupted run")
        check(any(bool(r.any()) for r in want["residual"]),
              f"ckpt {label}: every residual is zero; the check shows nothing")
        counts = {k: fn.launches for k, fn in counters.items()}

        bad = os.path.join(tmp, "corrupt")
        shutil.copytree(d, os.path.join(bad, os.path.basename(d)))
        npz = os.path.join(bad, os.path.basename(d), "arrays.npz")
        with open(npz, "r+b") as f:
            f.seek(nbytes["arrays.npz"] // 2)
            b = f.read(1)
            f.seek(nbytes["arrays.npz"] // 2)
            f.write(bytes([b[0] ^ 0x01]))
        try:
            checkpoint.verify(bad, 2)
            raised = False
        except checkpoint.CheckpointCorruptError:
            raised = True
        check(raised, f"ckpt {label}: a flipped byte was not caught")
    n = {part: len(v) for part, v in want.items()}
    print(f"[ckpt] {label}: {cfg.name}, 2 steps, save, 3 steps == restore into a "
          f"fresh trainer, 3 steps, bit for bit in {n} leaves (params, m, v, "
          f"residual, q), both steps {got_steps} and losses "
          f"{[round(v, 4) for v in losses]}; on disk {sum(nbytes.values())} B "
          f"{nbytes}; save {save_s:.3f} s (digest included), verify {digest_s:.3f} "
          f"s ({digest[:23]}...), restore {restore_s:.3f} s (verify included); a "
          f"flipped byte raises CheckpointCorruptError; launches {counts}",
          flush=True)
    return counts


def phase_replan(cfg, group, batches) -> int:
    """On the defaults, 2 steps at I = 4, then ``Trainer.replan(2)``: the
    residual norm is the same bit for bit (``carry``), and 3 more steps
    run the new plan with finite losses and ``ef_update`` once per new
    segment a step.  -> ``ef_update``'s launches in those 3 steps."""
    from repro_torch.runtime import residual_norm

    gc.collect()
    torch.cuda.empty_cache()
    tr, state = fresh_trainer(cfg, group, device=batches[0]["tokens"].device)
    state = tr.run(state, iter(batches[:2]), steps=2, log=None)
    old = (tr.plan.num_buckets, tr.plan.num_segments, tr.num_phases)
    before = residual_norm(state["comp"])
    state, rep = tr.replan(2, state, step=state["step"])
    after = residual_norm(state["comp"])
    check(rep.policy == "carry" and before == after == rep.norm_before == rep.norm_after,
          f"replan: residual norm {before} -> {after}, report {rep}")
    new = (tr.plan.num_buckets, tr.plan.num_segments, tr.num_phases)
    counters = zero_counters()
    state = tr.run(state, iter(batches[2:]), steps=3, log=None)
    counts = {k: fn.launches for k, fn in counters.items()}
    losses = [h["loss"] for h in tr.history[2:]]
    check(len(losses) == 3 and all(math.isfinite(v) for v in losses),
          f"replan: losses {losses}")
    check(counts == launch_counts(ef_update=3 * new[1]),
          f"replan: launches {counts} in 3 steps; the new plan has {new[1]} segments")
    print(f"[replan] defaults, after 2 steps at I=4: replan(2) carries the residual "
          f"(norm {before!r} before, {after!r} after, bit for bit); plan (buckets, "
          f"segments, phases) {old} -> {new}; 3 more steps, losses "
          f"{[round(v, 4) for v in losses]}; launches {counts}", flush=True)
    return counts["ef_update"]


def phase_oktopk_parity(tr, state, loader, group) -> None:
    """On the same gradients and residuals, ``oktopk`` in the one-rank
    group against ``topk``: the synced values and the new residuals bit for
    bit, on every bucket whose compensated values hold at least k non-zero
    elements (the regional top-k of a one-rank group then keeps exactly the
    local top-k)."""
    from repro_torch.core import bucketing as bk
    from repro_torch.core import get_compressor
    from repro_torch.core.comm import world_size
    from repro_torch.train import loss_and_grads

    batch = loader.make(state["step"])
    grads, _ = loss_and_grads(tr.model, state["params"], batch, group)
    out = {}
    for name in ("topk", "oktopk"):
        comp = get_compressor(name)
        sched = comp.plan_phase(tr.plan, 0, world=world_size(group))
        synced, resid, _ = comp.execute(sched, grads, state["comp"], step=state["step"],
                                        group=group)
        out[name] = (synced, resid)
    torch.cuda.synchronize()
    t = [g + r for g, r in zip(grads, state["comp"])]
    eligible, diff = [], 0
    for b, bucket in enumerate(tr.plan.buckets):
        k = max(1, math.ceil(bucket.numel * 0.01))
        nz = sum(int((bk._slice_segment(t[s.leaf_idx], s) != 0).sum())
                 for s in bucket.segments)
        if nz < k:
            continue
        eligible.append(b)
        for part in (0, 1):
            for s in bucket.segments:
                a = bk._slice_segment(out["oktopk"][part][s.leaf_idx], s)
                w = bk._slice_segment(out["topk"][part][s.leaf_idx], s)
                if not torch.equal(a, w):
                    diff += 1
    check(diff == 0, f"parity oktopk: {diff} segments differ from topk")
    check(len(eligible) == tr.plan.num_buckets,
          f"parity oktopk: only buckets {eligible} hold k non-zero values")
    print(f"[parity] oktopk step {state['step']}, same gradients, one-rank NCCL group "
          f"(all-to-all and all-gather run): synced values and residuals == topk's "
          f"bit for bit on all {len(eligible)} buckets (each holds >= k non-zero "
          f"values)", flush=True)


def phase_small() -> None:
    """REDUCED gpt2-paper on the card against the port on the CPU, on the
    defaults, with ``arena=True`` and with ``powersgd`` (whose Q is drawn on
    the CPU for both, and held up to QR's column signs)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_reduced("gpt2-paper")
    init = build_model(cfg, device="cpu", seed=3).state_dict()
    counters = kernel_counters()
    for label, opts, kernel in (("defaults", {}, "ef_update"),
                                ("arena", {"arena": True}, "pack_ef_cast"),
                                ("powersgd", {"compressor": "powersgd"}, MATMUL)):
        out = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, device=dev)
            model.load_state_dict(init)
            tr = Trainer(model, sgd(1e-2, momentum=0.9),
                         TrainConfig(bucket_bytes=1 << 14, max_buckets=32,
                                     steps=STEPS, log_every=1, **opts))
            loader = make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                            global_batch=4, corpus_tokens=1 << 14),
                                 device=dev)
            before = {k: f.launches for k, f in counters.items()}
            state = tr.run(tr.init_state(), loader, log=None)
            resid, qs = comp_parts(state["comp"])
            out[dev] = ([h["loss"] for h in tr.history],
                        [p.detach().cpu() for p in state["params"]],
                        [r.cpu() for r in resid], [q.cpu() for q in qs],
                        {k: f.launches - before[k] for k, f in counters.items()})
        (l_cpu, p_cpu, r_cpu, q_cpu, n_cpu) = out["cpu"]
        (l_gpu, p_gpu, r_gpu, q_gpu, n_gpu) = out["cuda"]
        per_step = (3 * len(lowrank_leaves(tr.plan)) if kernel == MATMUL
                    else tr.plan.num_segments)
        check(n_cpu == launch_counts() and n_gpu == launch_counts(**{kernel: STEPS * per_step}),
              f"small {label}: launches cpu {n_cpu}, cuda {n_gpu}")
        check(all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(l_gpu, l_cpu)),
              f"small {label}: losses cuda {l_gpu} vs cpu {l_cpu}")
        worst = 0.0
        for a, b in zip(p_gpu, p_cpu):
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-6),
                  f"small {label}: params differ between cuda and cpu (max |diff| "
                  f"{abs_err(a, b):.3g})")
            worst = max(worst, abs_err(a, b))
        if label != "powersgd":
            for a, b in zip(r_gpu, r_cpu):
                check(torch.allclose(a, b, rtol=1e-4, atol=1e-6),
                      f"small {label}: EF residuals differ between cuda and cpu")
                worst = max(worst, abs_err(a, b))
            how = "params and EF residuals at rtol 1e-4, atol 1e-6"
        else:
            # the warm-started Q carries last-bit differences from step to
            # step: residuals and Q (up to QR's column signs) are held as the
            # tests hold the port against the reference, rtol 1e-4 and atol
            # 1e-4 of the part's largest value
            for part, (got, want) in (("residual", (r_gpu, r_cpu)),
                                      ("Q", ([sign_aligned(a, b) for a, b in zip(q_gpu, q_cpu)],
                                             q_cpu))):
                scale = max(float(b.abs().max()) for b in want)
                rel = max(abs_err(a, b) for a, b in zip(got, want)) / scale
                check(all(torch.allclose(a, b, rtol=1e-4, atol=1e-4 * scale)
                          for a, b in zip(got, want)),
                      f"small powersgd: {part} differs between cuda and cpu "
                      f"(max |diff| {rel:.3g} of the largest)")
                worst = max(worst, rel)
            how = ("params at rtol 1e-4, atol 1e-6; residuals and Q (up to column "
                   "signs) at rtol 1e-4, atol 1e-4 of the part's largest; max |diff| "
                   "of params, or relative to the part's largest")
        print(f"[small] {label}: REDUCED, sgd, 5 steps: cuda losses "
              f"{[round(v, 5) for v in l_gpu]} match the cpu run (rtol 1e-4); "
              f"{how}: {worst:.3g}; {kernel} launches {n_gpu[kernel]}", flush=True)


def main() -> int:
    phase_device()
    import torch.distributed as dist

    from repro_torch.configs import get_config

    phase_build()
    records = [phase_kernels(), phase_pack_kernels(), *phase_wire_kernels(),
               phase_lowrank_kernels(), phase_threshold_kernels()]
    phase_adamw()
    by_name = {r["name"]: r for r in records}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        cfg = get_config("gpt2-paper")
        tr, state, loader, launches = phase_train(cfg, group=group)
        stats = {"defaults": tr.run_stats}
        segs = tr.plan.num_segments
        check(launches == launch_counts(ef_update=STEPS * segs),
              f"defaults: launches {launches} in {STEPS} steps; the plan has "
              f"{segs} segments")
        records[0]["launches"] = launches["ef_update"]
        phase_parity(tr, state, loader, group)
        del tr, state, loader
        torch.cuda.empty_cache()
        pack_launches = {}
        for label, options in PACK_RUNS:
            tr, state, _, launches = phase_train(cfg, group=group, label=label,
                                                 options=options)
            stats[label] = tr.run_stats
            check(launches == launch_counts(pack_ef_cast=STEPS * segs),
                  f"{label}: launches {launches} in {STEPS} steps; the plan has "
                  f"{segs} segments")
            pack_launches[label] = launches["pack_ef_cast"]
            del tr, state
            torch.cuda.empty_cache()
        for label, options, post_label, kernel in FUSED_RUNS:
            tr, state, loader, launches = phase_train(cfg, group=group, label=label,
                                                      options=options)
            check(launches == launch_counts(**{kernel: STEPS * segs}),
                  f"{label}: launches {launches} in {STEPS} steps; the plan has "
                  f"{segs} segments")
            if kernel == "ef_update":
                records[0]["launches"] += launches[kernel]
                records[0]["launches_by_run"] = {"defaults": STEPS * segs,
                                                 label: launches[kernel]}
            else:
                pack_launches[label] = launches[kernel]
            (ms_p, tok_p, peak_p), (ms_f, tok_f, peak_f) = (stats[post_label],
                                                            tr.run_stats)
            print(f"[train] {label} vs {post_label}: steps 1-{STEPS - 1} ms "
                  f"{[round(v, 2) for v in ms_f]} vs {[round(v, 2) for v in ms_p]}; "
                  f"{tok_f:.0f} vs {tok_p:.0f} tok/s; peak {peak_f:.2f} vs "
                  f"{peak_p:.2f} GiB; {check_fused_run(tr, label)}", flush=True)
            if label == "fused":
                phase_fused_parity(tr, state, loader, group)
            del tr, state, loader
            torch.cuda.empty_cache()
        records[1]["launches"] = sum(pack_launches.values())
        records[1]["launches_by_run"] = pack_launches
        for label, options in FLAT_RUNS:
            tr, state, loader, launches = phase_train(cfg, group=group, label=label,
                                                      options=options)
            nb = tr.plan.num_buckets
            want = (launch_counts(quantize_fp8=STEPS * nb,
                                  dequantize_fp8=2 * STEPS * nb)
                    if label == "fp8wire" else launch_counts(sign_compress=STEPS * nb))
            check(launches == want, f"{label}: launches {launches} in {STEPS} "
                  f"steps; the plan has {nb} buckets")
            for k, n in launches.items():
                if n and k in by_name:
                    by_name[k]["launches"] = n
            phase_flat_parity(tr, state, loader, group)
            del tr, state, loader
            torch.cuda.empty_cache()
        tr, state, loader, launches = phase_train(cfg, group=group, label="powersgd",
                                                  options={"compressor": "powersgd"})
        n = 3 * len(lowrank_leaves(tr.plan))
        check(launches == launch_counts(**{MATMUL: STEPS * n}),
              f"powersgd: launches {launches} in {STEPS} steps; {n} products a step")
        by_name[MATMUL]["launches"] = launches[MATMUL]
        from repro_torch.kernels.lowrank import matmul
        per_route = STEPS * len(lowrank_leaves(tr.plan))
        check(matmul.launches_by_route == {"rowdot": per_route, "colacc": per_route,
                                           "outer": per_route, "tiled": 0},
              f"powersgd: launches by route {matmul.launches_by_route}")
        by_name[MATMUL]["launches_by_route"] = dict(matmul.launches_by_route)
        print(f"[train] powersgd: lowrank.matmul launches by route "
              f"{matmul.launches_by_route}", flush=True)
        phase_powersgd_parity(tr, state, loader, group)
        del tr, state, loader
        torch.cuda.empty_cache()
        batches = ckpt_batches(cfg)
        for label, options in CKPT_RUNS:
            counts = phase_ckpt(cfg, group, label, options, batches)
            if label == "defaults":
                want = launch_counts(ef_update=8 * segs)
                records[0]["launches_by_run"]["ckpt defaults"] = counts["ef_update"]
            else:
                want = launch_counts(**{MATMUL: 8 * n})
                by_name[MATMUL]["launches_by_run"] = {"powersgd": by_name[MATMUL]["launches"],
                                                      "ckpt powersgd": counts[MATMUL]}
            check(counts == want, f"ckpt {label}: launches {counts}, want {want}")
        records[0]["launches_by_run"]["replan"] = phase_replan(cfg, group, batches)
        del batches
        for sparse in SPARSE_RUNS:
            tr, state, loader, launches = phase_train(cfg, group=group, label=sparse,
                                                      options={"compressor": sparse})
            check(launches == launch_counts(),
                  f"{sparse}: launches {launches}; the sparsifiers run no kernel")
            sr = tr.schedule_report()
            print(f"[train] {sparse}: plan {sr['mean_bytes_per_step']:.0f} B per worker "
                  f"per step at W={tr.dp_world} (dense {sr['dense_bytes']} B, volume "
                  f"ratio {sr['volume_ratio']:.2f}), "
                  f"{len(tr.schedules()[0].calls)} collectives a step", flush=True)
            if sparse == "topk":
                phase_oktopk_parity(tr, state, loader, group)
            del tr, state, loader
            torch.cuda.empty_cache()
        # last, since the steps that follow a profiled one run slower: a
        # fresh fused run, then one profiled post and fused step
        tr, state, loader, launches = phase_train(
            cfg, group=group, label="fused, for [overlap]", options={"overlap": "fused"})
        check(launches == launch_counts(ef_update=STEPS * segs),
              f"fused, for [overlap]: launches {launches}")
        phase_overlap(tr, state, loader, group)
        del tr, state, loader
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    phase_small()
    idle = [r["name"] for r in records if r.get("path", "") is not None
            and not r["launches"]]
    check(not idle, f"kernels never launched on their path: {idle}")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
