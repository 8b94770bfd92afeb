"""One rank of a benchmark run: the system under test built from the
cell's files, its first COVAP cycle (the numbers the comparison reads
captured on the way), the measured window, the profiled steps, and on rank
0 the reference and the comparison.

The window drives ``repro_torch.train.Trainer.step``, fed by
``repro_torch.data.make_loader``, as the training CLI does.  It starts at
a synchronised step boundary and ends at the first step boundary after
``seconds``, synchronised again; a step's time is the gap between CUDA
events recorded on the current stream at consecutive boundaries.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from . import check, reference, sketch, weights
from .reference import train as ref_train
from .yardstick import ef_bytes
from .yardstick.trace import LOADER_SPAN, STEP_SPAN, TraceView

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
GIB = 2**30
BARRIER_TIMEOUT = timedelta(minutes=15)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    conf: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """A cell of ``BENCHMARK.json`` with its configuration's and traffic
    mix's files, its limits, and the metrics it reports."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in spec["configs"] if c["name"] == work["config"])

    def applies(metric):
        return name in metric.get("workloads", [name])

    return Cell(
        name=name,
        chips=work["chips"],
        conf=json.loads((root / conf_entry["file"]).read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{work['traffic']}.json").read_text()),
        limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)],
    )


def reader(metric: str):
    """The reader of a per-layer metric: ``bench/metrics/<metric>.py``'s
    ``read(view) -> float | None``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache in fixed directories of the checkout."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def build_kernels(cell: Cell) -> None:
    """Build the CUDA kernels the cell's path launches (nothing when they
    are built already)."""
    from repro_torch.kernels import _build

    for name in cell.traffic["kernels"]:
        _build.build(name)


class Program:
    """The system under test for one rank: the model with the run's
    weights, AdamW, the ``Trainer`` and the data loader."""

    def __init__(self, cell: Cell, seed: int, *, rank: int, world: int, device, group):
        from repro_torch.configs.base import ArchConfig
        from repro_torch.data import DataConfig, make_loader
        from repro_torch.models import build_model
        from repro_torch.optim import adamw
        from repro_torch.train.trainer import TrainConfig, Trainer

        conf, t, o = cell.conf, cell.traffic, cell.conf["optimizer"]
        fields = {f.name for f in dataclasses.fields(ArchConfig)}
        cfg = ArchConfig(**{k: v for k, v in conf.items() if k in fields})
        marks = [time.perf_counter()]
        self.model = build_model(cfg, device=device, seed=0)
        marks.append(time.perf_counter())
        ref = reference.of(conf)
        self.rule = getattr(ref, "std_of", None)
        self.paths = list(ref.param_shapes(ref.Arch.from_config(conf)))
        leaves = self.model.named_leaves()
        if [p for p, _ in leaves] != self.paths:
            raise RuntimeError("the model's leaves are not the reference's")
        for i, (path, p) in enumerate(leaves):
            weights.fill_leaf(p.data, seed, i, path, self.rule)
        marks.append(time.perf_counter())
        self.b1 = o["b1"]
        opt = adamw(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                    weight_decay=o["weight_decay"], moment_dtype=o["moment_dtype"])
        tc = TrainConfig(compressor=t["compressor"], interval=t["interval"],
                         overlap=t["overlap"], arena=t["arena"], sync=t["sync"],
                         bucket_bytes=t["bucket_bytes"], max_buckets=t["max_buckets"])
        self.trainer = Trainer(self.model, opt, tc, group=group)
        self.state = self.trainer.init_state()
        marks.append(time.perf_counter())
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=t["seq_len"],
                        global_batch=t["rows_per_chip"] * world, seed=seed)
        self.loader = iter(make_loader(dc, world, rank, device=device))
        marks.append(time.perf_counter())
        self.cell, self.seed = cell, seed
        self.timings = dict(zip(("build_model", "weights", "trainer", "loader"),
                                (b - a for a, b in zip(marks, marks[1:]))))

    def step(self):
        batch = next(self.loader)
        self.state, metrics = self.trainer.step(self.state, batch)
        return metrics

    def first_cycle(self) -> dict:
        """Runs the first COVAP cycle (every phase's step once) and returns
        what the comparison reads: each step's loss, each element's first
        gradient as the optimizer got it over the cycle (its bucket's first
        send) as a norm and projections a leaf, and the parameters' change
        a leaf over the cycle."""
        steps = self.trainer.num_phases
        if steps != ref_train.cycle(self.cell.traffic):
            raise RuntimeError(f"{steps} phases, the reference's cycle differs")
        out = {"loss": []}
        first = [torch.zeros_like(p, dtype=torch.float32) for p in self.state["params"]]
        self.cycle_s = []
        for _ in range(steps):
            t0 = time.perf_counter()
            metrics = self.step()
            with torch.no_grad():
                out["loss"].append(float(metrics["total_loss"]))
                ref_train.first_sent(first, self.state["opt"]["m"], self.b1)
            self.cycle_s.append(time.perf_counter() - t0)
        with torch.no_grad():
            out["grad"] = [float(torch.linalg.vector_norm(g)) for g in first]
            out["sketch"] = [sketch.project(g, self.seed, i) for i, g in enumerate(first)]
            del first
            out["change"] = [
                float(torch.linalg.vector_norm(
                    p - weights.fill_leaf(torch.empty_like(p), self.seed, i, path,
                                          self.rule)))
                for i, (path, p) in enumerate(zip(self.paths, self.state["params"]))]
        return out


class Clock:
    """Step boundaries: CUDA events on the current stream, or the host
    clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


class Ranks:
    """The run's process group: NCCL on the cards (gloo on the CPU) for the
    system under test, and a gloo group for the harness's own barriers,
    stop flags and gathers."""

    def __init__(self, rank: int, world: int, port: int, device):
        self.rank, self.world, self.device = rank, world, torch.device(device)
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        kw = {"device_id": self.device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank, **kw)
        self.group = dist.group.WORLD
        self.host = dist.new_group(backend="gloo", timeout=BARRIER_TIMEOUT)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        if self.world > 1:
            dist.barrier(group=self.host)

    def any_rank0(self, flag: bool) -> bool:
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)])
        dist.broadcast(t, src=0, group=self.host)
        return bool(t.item())

    def gather(self, obj) -> list:
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        dist.gather_object(obj, out if self.rank == 0 else None, dst=0, group=self.host)
        return out

    def close(self):
        dist.destroy_process_group()


def window(prog: Program, ranks: Ranks, seconds: float, *, min_steps: int = 1) -> dict:
    """Steps from a synchronised boundary to the first boundary after
    ``seconds``; ``{"steps", "wall_s", "step_ms"}``."""
    clock = Clock(ranks.device)
    ranks.sync()
    t0 = time.perf_counter()
    clock.mark()
    steps = 0
    while True:
        prog.step()
        clock.mark()
        steps += 1
        if ranks.any_rank0(steps >= min_steps and time.perf_counter() - t0 >= seconds):
            break
    ranks.sync()
    wall = time.perf_counter() - t0
    return {"steps": steps, "wall_s": wall, "step_ms": clock.step_ms()}


def profiled(prog: Program, ranks: Ranks, steps: int, trace_path: Path):
    """``steps`` steps under ``torch.profiler``, each in a ``bench/step``
    span, its ``next(loader)`` in a ``bench/loader`` span; the trace is
    written to ``trace_path``.  Returns the profiled window's wall seconds
    and each step's phase."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if ranks.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    phases = []
    with profile(activities=acts) as prof:
        ranks.sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            phases.append(prog.state["step"] % prog.trainer.num_phases)
            with record_function(STEP_SPAN):
                with record_function(LOADER_SPAN):
                    batch = next(prog.loader)
                prog.state, _ = prog.trainer.step(prog.state, batch)
        ranks.sync()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace_path))
    del prof
    gc.collect()
    return wall, phases


def read_trace(trace_path: Path) -> list[dict]:
    """The events of a trace :func:`profiled` wrote; the file is removed."""
    try:
        return json.loads(trace_path.read_text())["traceEvents"]
    finally:
        trace_path.unlink(missing_ok=True)


def percentile(values: list[float], q: int) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def spawn_ranks(script: str, argv: list[str], chips: int, port: int) -> list:
    """Ranks 1 .. ``chips - 1`` of a run: ``script`` with ``argv`` and the
    rank and port, their standard output sent to this one's standard
    error."""
    import subprocess

    return [subprocess.Popen([sys.executable, script, *argv, "--rank", str(r),
                              "--port", str(port)], stdout=sys.stderr)
            for r in range(1, chips)]


def run_rank(cell: Cell, *, seed: int, seconds: float, trace: bool, rank: int,
             world: int, port: int, device, t_start: float, patch=None) -> dict | None:
    """One rank's run.  Returns the result line's fields on rank 0 (None on
    the others).  ``patch(prog)``, when given, breaks the system under test
    before its first step (the tests' faults)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ranks = Ranks(rank, world, port, dev)
    try:
        return _run(cell, ranks, seed=seed, seconds=seconds, trace=trace,
                    t_start=t_start, patch=patch)
    finally:
        ranks.close()


def _run(cell, ranks, *, seed, seconds, trace, t_start, patch):
    dev = ranks.device
    cuda = dev.type == "cuda"
    t_build = time.perf_counter()
    prog = Program(cell, seed, rank=ranks.rank, world=ranks.world, device=dev,
                   group=ranks.group)
    if patch is not None:
        patch(prog)
    t_cycle = time.perf_counter()
    captured = prog.first_cycle()
    ranks.sync()
    setup_s = time.perf_counter() - t_start
    if ranks.rank == 0:
        print(f"bench: set-up {setup_s:.3f} s: to the build {t_build - t_start:.3f} s, "
              f"the build {t_cycle - t_build:.3f} s, the first cycle "
              f"{time.perf_counter() - t_cycle:.3f} s; "
              + ", ".join(f"{k} {v:.3f} s" for k, v in prog.timings.items())
              + "; its steps " + ", ".join(f"{v:.3f}" for v in prog.cycle_s) + " s",
              file=sys.stderr)
    rows = cell.traffic["rows_per_chip"] * ranks.world
    seq = cell.traffic["seq_len"]
    mine: dict = {"captured": captured}
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if not trace:
        win = window(prog, ranks, seconds)
        mine["peak"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
    else:
        n_prof = cell.traffic["profiled_cycles"] * prog.trainer.num_phases
        trace_path = Path(tempfile.gettempdir()) / f"bench-trace-{os.getpid()}.json"
        t0 = time.perf_counter()
        prof_wall, phases = profiled(prog, ranks, n_prof, trace_path)
        left = max(seconds - (time.perf_counter() - t0), 0.0)
        win = window(prog, ranks, left, min_steps=prog.trainer.num_phases)
        win["attempted"] = win["steps"] + n_prof
        mine["peak"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
        events = read_trace(trace_path)
        buckets, shapes = ef_bytes.plan_of(cell.conf, cell.traffic)
        interval = cell.traffic["interval"]
        steps = [{"phase": p, "ef_bytes": ef_bytes.ef_bytes(buckets, shapes, p, interval)}
                 for p in phases]
        step_flops = reference.of(cell.conf).step_flops(cell.conf, rows=rows, seq_len=seq)
        context = {"flops_per_step": step_flops, "chips": ranks.world,
                   "untraced_steps": win["steps"], "untraced_s": win["wall_s"],
                   "conf": cell.conf, "traffic": cell.traffic, "rows": rows,
                   "seq_len": seq}
        view = TraceView(events, steps=steps, window_us=prof_wall * 1e6, context=context)
        del events
        mine["busy_s"] = view.busy_us() / 1e6
        mine["window_s"] = prof_wall
        if ranks.rank == 0:
            mine["per_layer"] = {m["name"]: reader(m["name"])(view) for m in cell.per_layer}
            mine["breakdown"] = {"device_ops": view.top_groups(),
                                 "idle_gaps": view.idle_gaps()}
        del view
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    every = ranks.gather(mine)
    if ranks.rank != 0:
        ranks.sync()
        return None
    ref = ref_train.run(cell.conf, cell.traffic, seed=seed, workers=ranks.world,
                        device=dev)
    found = check.gaps([m["captured"] for m in every], ref)
    ranks.sync()
    out = {
        "correct": check.verdict(found, cell.limits),
        "attempted": win.get("attempted", win["steps"]),
        "failed": 0,
        "checks": {k: {"value": found[k], "limit": limit} for k, limit in cell.limits.items()},
        "peak": max(m["peak"] for m in every),
    }
    if not trace:
        out["metrics"] = {
            "train_tokens_per_s": win["steps"] * rows * seq / win["wall_s"],
            "step_ms_p90": percentile(win["step_ms"], 90),
            "peak_mem_gib": out["peak"] / GIB,
            "setup_s": setup_s,
        }
    else:
        out["metrics"] = {k: v for k, v in every[0]["per_layer"].items() if v is not None}
        out["busy_s"] = sum(m["busy_s"] for m in every) / ranks.world
        out["window_s"] = every[0]["window_s"]
        out["breakdown"] = every[0]["breakdown"]
    return out

