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
           over one full-width step's segments with CUDA events
  train    full-width gpt2-paper (190,532,352 parameters), COVAP I=4, AdamW,
           seq 1024, global batch 8, 5 steps in a one-rank NCCL process
           group, four times: the ``TrainConfig`` defaults (every loss
           finite, ``ef_update.launches`` == segments x steps), then
           ``arena=True``, ``arena=True`` with a bf16 wire, and
           ``sync="sharded"`` (``pack_ef_cast.launches`` == segments x
           steps and ``ef_update.launches`` == 0 on each)
  parity   one step from the trained state on the same gradients: each
           kernel against its plain version, arena against per-segment
           (f32 and bf16 wires) and sharded against allreduce, bit for bit
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
STEPS = 5
KERNELS = ("ef_covap", "pack_ef_cast")
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
    (``{"ef_update": n, "pack_ef_cast": m}``)."""
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.kernels.ef_covap import ef_update
    from repro_torch.kernels.pack_ef_cast import pack_ef_cast
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
    ef_update.launches = 0
    pack_ef_cast.launches = 0
    state = tr.run(state, loader, steps=STEPS, log=lines.append)
    launches = {"ef_update": ef_update.launches,
                "pack_ef_cast": pack_ef_cast.launches}
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
          f"I={tc.interval} {tc.overlap} {tc.sync} arena={'on' if tc.arena else 'off'} "
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
    records = [phase_kernels(), phase_pack_kernels()]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        cfg = get_config("gpt2-paper")
        tr, state, loader, launches = phase_train(cfg, group=group)
        segs = tr.plan.num_segments
        check(launches == {"ef_update": STEPS * segs, "pack_ef_cast": 0},
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
            check(launches == {"ef_update": 0, "pack_ef_cast": STEPS * segs},
                  f"{label}: launches {launches} in {STEPS} steps; the plan has "
                  f"{segs} segments")
            pack_launches[label] = launches["pack_ef_cast"]
            del tr, state
            torch.cuda.empty_cache()
        records[1]["launches"] = sum(pack_launches.values())
        records[1]["launches_by_run"] = pack_launches
    finally:
        dist.destroy_process_group()
    phase_small()
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
