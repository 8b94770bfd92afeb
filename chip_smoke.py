"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Each phase prints one line; any failure raises and the script exits non-zero.

  device   needs ``torch.cuda``; prints the card and its power limit, turns
           TF32 off for float32 matrix products and convolutions
  build    compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
  kernels  holds ``ef_update`` against its plain PyTorch version on the card
           (ragged, unaligned, largest segment, whole embedding table) and
           times it over one full-width step's segments with CUDA events
  train    full-width gpt2-paper (190,532,352 parameters), COVAP I=4 on the
           ``TrainConfig`` defaults, AdamW, seq 1024, global batch 8, 5 steps
           in a one-rank NCCL process group; every loss finite and
           ``ef_update.launches`` == segments x steps
  parity   one step from the trained state with the kernel and with
           ``use_ef_kernel=False``, on the same gradients
  small    REDUCED gpt2-paper trained 5 steps on the card and on the CPU
           from the same parameters and batches (the CPU run is the path the
           tests hold against the JAX reference)

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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
EF_COEFF = 0.3           # EFSchedule().coefficient(step) for step < 200
EF_BYTES_PER_ELEM = 16   # read g and r, write send and r' (float32 each)
STEPS = 5


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

    path, log, secs = _build.build("ef_covap")
    ptxas = "; ".join(
        " ".join(line.split()) for line in log.splitlines()
        if "Used" in line or "spill" in line
    )
    print(f"[build] ef_covap.cu -> {path.relative_to(ROOT)} in {secs:.2f} s "
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
        (s.numel(plan.leaf_shapes[s.leaf_idx]), b.index in selected)
        for b in plan.buckets for s in b.segments
    ]
    total = sum(n for n, _ in numels)
    gen = torch.Generator(device).manual_seed(1)
    g_all = torch.randn(total, generator=gen, device=device)
    r_all = torch.randn(total, generator=gen, device=device)
    segs, off = [], 0
    for n, sel in numels:
        segs.append((g_all[off:off + n], r_all[off:off + n], sel))
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
        for g, r, sel in segs:
            ef_update(g, r, c, selected=sel)

    def run_plain():
        for g, r, sel in segs:
            ef_update_ref(g, r, c, selected=sel)

    def run_library():
        for g, r, _ in segs:
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
                group=None):
    """Full-width training through ``Trainer.run``.  Returns the trainer,
    its state and the loader, and the ``ef_update`` launches of the run."""
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.kernels.ef_covap import ef_update
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train import TrainConfig, Trainer

    model = build_model(cfg, device=device, seed=0)
    opt = adamw(cosine_warmup(1.5e-4, STEPS // 10 + 1, STEPS))
    tc = TrainConfig(steps=STEPS, log_every=1)
    check((tc.compressor, tc.interval, tc.overlap, tc.arena, tc.sync)
          == ("covap", 4, "post", False, "allreduce"),
          f"TrainConfig defaults moved: {tc}")
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
    state = tr.run(state, loader, steps=STEPS, log=lines.append)
    launches = ef_update.launches
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
    print(f"[train] {cfg.name} {n_params} params, {tr.plan.num_buckets} "
          f"buckets / {tr.plan.num_segments} segments, covap I={tc.interval} "
          f"post allreduce arena=off, adamw, seq {seq_len} x batch "
          f"{global_batch}, world {tr.dp_world}: losses "
          f"{[round(v, 4) for v in losses]}  step 0 {1e3 * hist[0]['wall_s']:.1f} ms, "
          f"steps 1-{STEPS - 1} ms {[round(v, 2) for v in step_ms]}  "
          f"{tok_s:.0f} tok/s after step 0  peak {peak:.2f} GiB  "
          f"ef_update launches {launches}", flush=True)
    return tr, state, loader, launches


def phase_parity(tr, state, loader, group) -> None:
    from repro_torch.core import get_compressor
    from repro_torch.kernels.ef_covap import ef_update
    from repro_torch.train import build_step_fn, loss_and_grads

    batch = loader.make(state["step"])
    phase = state["step"] % tr.num_phases
    grads, _ = loss_and_grads(tr.model, state["params"], batch, group)
    runs = []
    for use in (None, False):
        comp = get_compressor("covap", interval=tr.tc.interval, use_ef_kernel=use)
        fn = build_step_fn(tr.model, tr.optimizer, comp, tr.plan, phase=phase,
                           group=group)
        before = ef_update.launches
        new, _ = fn.update(clone_tree(state), grads)
        runs.append((new, ef_update.launches - before))
    (k_state, k_launches), (p_state, p_launches) = runs
    check(k_launches == tr.plan.num_segments and p_launches == 0,
          f"parity launches: kernel run {k_launches}, plain run {p_launches}")
    c = get_compressor("covap", interval=tr.tc.interval).ef_coefficient(state["step"])
    worst = 0.0
    for what in ("params", "comp"):
        for a, b, r in zip(k_state[what], p_state[what], state["comp"]):
            check(ef_close(a, b, r, c), f"parity: {what} disagree")
            worst = max(worst, float((a - b).abs().max()))
    print(f"[parity] step {state['step']} (phase {phase}): kernel vs "
          f"use_ef_kernel=False on the same gradients, params and residuals "
          f"agree (max |diff| {worst:.3g}); launches {k_launches} vs "
          f"{p_launches}", flush=True)


def phase_small() -> None:
    """REDUCED gpt2-paper on the card against the port on the CPU."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.kernels.ef_covap import ef_update
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_reduced("gpt2-paper")
    init = build_model(cfg, device="cpu", seed=3).state_dict()
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        model.load_state_dict(init)
        tr = Trainer(model, sgd(1e-2, momentum=0.9),
                     TrainConfig(bucket_bytes=1 << 14, max_buckets=32,
                                 steps=STEPS, log_every=1))
        loader = make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                        global_batch=4, corpus_tokens=1 << 14),
                             device=dev)
        before = ef_update.launches
        state = tr.run(tr.init_state(), loader, log=None)
        out[dev] = ([h["loss"] for h in tr.history],
                    [p.detach().cpu() for p in state["params"] + state["comp"]],
                    ef_update.launches - before)
    (l_cpu, t_cpu, n_cpu), (l_gpu, t_gpu, n_gpu) = out["cpu"], out["cuda"]
    check(n_cpu == 0 and n_gpu == STEPS * tr.plan.num_segments,
          f"small: launches cpu {n_cpu}, cuda {n_gpu}")
    check(all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(l_gpu, l_cpu)),
          f"small: losses cuda {l_gpu} vs cpu {l_cpu}")
    worst = 0.0
    for a, b in zip(t_gpu, t_cpu):
        check(torch.allclose(a, b, rtol=1e-4, atol=1e-6),
              "small: params or residuals differ between cuda and cpu")
        worst = max(worst, float((a - b).abs().max()))
    print(f"[small] REDUCED, sgd, 5 steps: cuda losses {[round(v, 5) for v in l_gpu]} "
          f"match the cpu run (rtol 1e-4); params and EF residuals max |diff| "
          f"{worst:.3g} (rtol 1e-4, atol 1e-6); ef_update launches {n_gpu}",
          flush=True)


def main() -> int:
    name, _ = phase_device()
    import torch.distributed as dist

    from repro_torch.configs import get_config

    phase_build()
    record = phase_kernels()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        tr, state, loader, launches = phase_train(get_config("gpt2-paper"),
                                                  group=group)
        check(launches == STEPS * tr.plan.num_segments,
              f"ef_update launched {launches} times in {STEPS} steps; the plan "
              f"has {tr.plan.num_segments} segments")
        record["launches"] = launches
        phase_parity(tr, state, loader, group)
        del tr, state, loader
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    phase_small()
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
