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
           step's buckets
  train    full-width gpt2-paper (190,532,352 parameters), AdamW, seq 1024,
           global batch 8, 5 steps in a one-rank NCCL process group, six
           times: COVAP I=4 on the ``TrainConfig`` defaults (every loss
           finite, ``ef_update.launches`` == segments x steps), then
           ``arena=True``, ``arena=True`` with a bf16 wire, and
           ``sync="sharded"`` (``pack_ef_cast.launches`` == segments x
           steps and ``ef_update.launches`` == 0 on each); then the
           flat-bucket path, ``fp8wire`` (``quantize_fp8.launches`` ==
           buckets x steps, ``dequantize_fp8.launches`` == 2 x buckets x
           steps) and ``efsignsgd`` (``sign_compress.launches`` == buckets x
           steps); every other kernel's count must be 0 on each run
  parity   one step from the trained state on the same gradients: each
           kernel against its plain version, arena against per-segment
           (f32 and bf16 wires) and sharded against allreduce, bit for bit;
           for each flat wire, the kernels against ``use_wire_kernel=False``
           (fp8wire bit for bit; efsignsgd signs bit for bit, values at rtol
           1e-6) and the arena against the per-bucket form, bit for bit
  small    REDUCED gpt2-paper trained 5 steps on the card and on the CPU
           from the same parameters and batches, on the defaults and with
           ``arena=True`` (the CPU run is the path the tests hold against
           the JAX reference)

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
KERNELS = ("ef_covap", "pack_ef_cast", "quantize_fp8", "sign_compress")
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
    from repro_torch.kernels.pack_ef_cast import pack_ef_cast
    from repro_torch.kernels.quantize import dequantize_fp8, quantize_fp8
    from repro_torch.kernels.sign_compress import sign_compress

    return {f.__name__: f for f in (ef_update, pack_ef_cast, quantize_fp8,
                                    dequantize_fp8, sign_compress)}


def launch_counts(**nonzero) -> dict:
    """The expected launch counts of a run: 0 for every kernel but those
    named."""
    return {name: nonzero.get(name, 0) for name in kernel_counters()}


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

    def run_library():
        for g, r, *_ in segs:
            torch.add(g, r, alpha=c)

    run_kernel = kernel_fn(None)
    kernel_ms = device_timed(run_kernel)
    kernel_bf16_ms = device_timed(kernel_fn(torch.bfloat16))
    plain_ms = device_timed(run_plain)
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
          f"kernel wall ms with host dispatch {kernel_wall_ms:.4f}",
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


def phase_train(cfg, *, device="cuda", seq_len=1024, global_batch=8,
                group=None, label="defaults", options=None):
    """Full-width training through ``Trainer.run`` on the ``TrainConfig``
    defaults updated with ``options``.  Returns the trainer, its state and
    the loader, and the launches of each kernel in the run
    (``{"ef_update": n, "pack_ef_cast": m, ...}``, every kernel)."""
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train import TrainConfig, Trainer

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
    print(f"[train] {label}: {cfg.name} {n_params} params, {tr.plan.num_buckets} "
          f"buckets / {tr.plan.num_segments} segments, {tc.compressor} "
          f"{tr.num_phases} phase(s) {tc.overlap} {tc.sync} "
          f"arena={'on' if tc.arena else 'off'} "
          f"wire={wire}, adamw, seq {seq_len} x batch {global_batch}, world "
          f"{tr.dp_world}: losses {[round(v, 4) for v in losses]}  step 0 "
          f"{1e3 * hist[0]['wall_s']:.1f} ms, steps 1-{STEPS - 1} ms "
          f"{[round(v, 2) for v in step_ms]}  {tok_s:.0f} tok/s after step 0  "
          f"peak {peak:.2f} GiB  launches {launches}", flush=True)
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


def phase_small() -> None:
    """REDUCED gpt2-paper on the card against the port on the CPU, on the
    defaults and with ``arena=True``."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.kernels.ef_covap import ef_update
    from repro_torch.kernels.pack_ef_cast import pack_ef_cast
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_reduced("gpt2-paper")
    init = build_model(cfg, device="cpu", seed=3).state_dict()
    for label, opts, kernel in (("defaults", {}, ef_update),
                                ("arena", {"arena": True}, pack_ef_cast)):
        other = pack_ef_cast if kernel is ef_update else ef_update
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
            before, before_other = kernel.launches, other.launches
            state = tr.run(tr.init_state(), loader, log=None)
            out[dev] = ([h["loss"] for h in tr.history],
                        [p.detach().cpu() for p in state["params"] + state["comp"]],
                        kernel.launches - before, other.launches - before_other)
        (l_cpu, t_cpu, n_cpu, o_cpu), (l_gpu, t_gpu, n_gpu, o_gpu) = out["cpu"], out["cuda"]
        check(n_cpu == 0 and n_gpu == STEPS * tr.plan.num_segments
              and o_cpu == o_gpu == 0,
              f"small {label}: launches cpu {n_cpu}, cuda {n_gpu}, other "
              f"kernel {o_cpu}, {o_gpu}")
        check(all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(l_gpu, l_cpu)),
              f"small {label}: losses cuda {l_gpu} vs cpu {l_cpu}")
        worst = 0.0
        for a, b in zip(t_gpu, t_cpu):
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-6),
                  f"small {label}: params or residuals differ between cuda and cpu")
            worst = max(worst, float((a - b).abs().max()))
        print(f"[small] {label}: REDUCED, sgd, 5 steps: cuda losses "
              f"{[round(v, 5) for v in l_gpu]} match the cpu run (rtol 1e-4); "
              f"params and EF residuals max |diff| {worst:.3g} (rtol 1e-4, atol "
              f"1e-6); {kernel.__name__} launches {n_gpu}", flush=True)


def main() -> int:
    name, _ = phase_device()
    import torch.distributed as dist

    from repro_torch.configs import get_config

    phase_build()
    records = [phase_kernels(), phase_pack_kernels(), *phase_wire_kernels()]
    by_name = {r["name"]: r for r in records}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        cfg = get_config("gpt2-paper")
        tr, state, loader, launches = phase_train(cfg, group=group)
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
            check(launches == launch_counts(pack_ef_cast=STEPS * segs),
                  f"{label}: launches {launches} in {STEPS} steps; the plan has "
                  f"{segs} segments")
            pack_launches[label] = launches["pack_ef_cast"]
            del tr, state
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
    finally:
        dist.destroy_process_group()
    phase_small()
    idle = [r["name"] for r in records if not r["launches"]]
    check(not idle, f"kernels never launched on the main path: {idle}")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
