"""Reading a ``torch.profiler`` trace of a run's profiled steps: the
device's busy time, kernel groups, the host's runtime calls and the
device's idle gaps.

The trace is the Chrome-trace event list of the profile (each event a dict
with ``name``, ``cat``, ``ts`` and ``dur`` in microseconds, ``tid`` and
``args``).  Each profiled step runs inside a host span ``bench/step``;
a device operation belongs to the step whose span holds the host call
that launched it (the two share ``args["correlation"]``).
"""
from __future__ import annotations

import bisect
from collections import defaultdict

STEP_SPAN = "bench/step"
LOADER_SPAN = "bench/loader"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D", "cudaMemset")

# kernel-name fragments, matched in order on the lower-cased name
GROUPS = (
    ("ef_update", ("ef_update_kernel",)),
    ("pack_ef_cast", ("pack_ef_cast_kernel",)),
    ("dequantize_fp8", ("dequantize_fp8_kernel",)),
    ("quantize_fp8", ("quantize_fp8_kernel",)),
    ("sign_compress", ("sign_compress_kernel",)),
    ("lowrank.matmul", ("lowrank_matmul_kernel", "lowrank_splitk_reduce_kernel")),
    ("threshold_filter", ("threshold_filter_kernel",)),
    ("qr", ("geqr", "orgqr", "ungqr", "larf", "householder", "cusolver", "magma")),
    ("nccl", ("nccl",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_")),
    ("softmax/logsumexp", ("softmax", "logsumexp")),
    ("index/scatter/gather", ("index", "scatter", "gather")),
    ("sort/topk/scan", ("sort", "topk", "scan", "cumsum")),
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


def union(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def _end(e: dict) -> float:
    return e["ts"] + e.get("dur", 0.0)


class TraceView:
    """A profiled window's trace, split into its steps.

    ``steps`` is one entry a profiled step, in order: ``{"phase": p}`` and
    whatever the readers need of it.  ``window_us`` is the profiled
    window's wall time.  ``context`` is the run's: in a run of
    ``bench/harness.py``, ``flops_per_step``, ``chips``, ``untraced_steps``
    and ``untraced_s`` (the untraced steps after the profile, and their wall
    seconds), ``conf`` and ``traffic`` (the cell's configuration and traffic
    files' objects), ``rows`` (a step's rows over every chip) and
    ``seq_len``, from which a reader counts a kernel's operations and
    bytes."""

    def __init__(self, events: list[dict], *, steps: list[dict], window_us: float,
                 context: dict):
        self.window_us = window_us
        self.context = context
        events = sorted((e for e in events if e.get("ph") == "X"), key=lambda e: e["ts"])
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.calls = [e for e in events if e.get("cat") in HOST_CATS]
        self.spans = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")]
        self.step_spans = [(e["ts"], _end(e)) for e in self.spans if e["name"] == STEP_SPAN]
        if len(self.step_spans) != len(steps):
            raise ValueError(f"{len(self.step_spans)} {STEP_SPAN} spans in the trace, "
                             f"{len(steps)} profiled steps")
        self.steps = steps
        self.n_steps = len(steps)
        starts = self._starts = [s for s, _ in self.step_spans]
        self.calls_by_tid: dict = defaultdict(list)
        for c in self.calls:
            self.calls_by_tid[c.get("tid")].append(c)
        self.call_ts_by_tid = {t: [c["ts"] for c in cs] for t, cs in self.calls_by_tid.items()}
        launch_step = {}
        for c in self.calls:
            corr = c.get("args", {}).get("correlation")
            i = bisect.bisect_right(starts, c["ts"]) - 1
            if corr is not None and i >= 0 and c["ts"] <= self.step_spans[i][1]:
                launch_step[corr] = i
        self.launch_step = launch_step
        self.kernels_by_step: list[list[dict]] = [[] for _ in steps]
        for e in self.device:
            i = launch_step.get(e.get("args", {}).get("correlation"))
            if i is not None:
                self.kernels_by_step[i].append(e)

    def in_steps(self, e: dict) -> bool:
        """Whether host event ``e`` starts inside a profiled step's span."""
        i = bisect.bisect_right(self._starts, e["ts"]) - 1
        return i >= 0 and e["ts"] <= self.step_spans[i][1]

    def busy_us(self) -> float:
        """The union of every device operation's interval."""
        return length((e["ts"], _end(e)) for e in self.device)

    def group_us(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for e in self.device:
            out[kernel_group(e["name"])] += e.get("dur", 0.0)
        return dict(out)

    def calls_named(self, test) -> int:
        return sum(1 for c in self.calls if test(c["name"]) and self.in_steps(c))

    def top_groups(self, n: int = 10) -> list[list]:
        """The device's groups by time, seconds a step."""
        ranked = sorted(self.group_us().items(), key=lambda kv: -kv[1])[:n]
        return [[g, us / 1e6 / self.n_steps] for g, us in ranked]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The device's idle time inside the profiled steps, by the host
        operation open on the stepping thread when each gap began (the
        innermost one), seconds a step, the largest first."""
        busy = union((e["ts"], _end(e)) for e in self.device)
        main_tid = next((e.get("tid") for e in self.spans if e["name"] == STEP_SPAN), None)
        host = [e for e in self.spans if e.get("tid") == main_tid and e["name"] != STEP_SPAN]
        starts = [e["ts"] for e in host]
        gaps = []
        for lo, hi in self.step_spans:
            edge = lo
            for s, e in busy + [(hi, hi)]:
                if e <= edge:
                    continue
                if s > edge:
                    gaps.append((edge, min(s, hi)))
                edge = max(edge, e)
                if edge >= hi:
                    break
        by_name: dict[str, float] = defaultdict(float)
        for g0, g1 in gaps:
            if g1 <= g0:
                continue
            i = bisect.bisect_right(starts, g0)
            name = "(python, between host ops)"
            for e in reversed(host[max(0, i - 200):i]):
                if _end(e) >= g0:
                    name = e["name"]
                    break
            by_name[name] += g1 - g0
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[k, us / 1e6 / self.n_steps] for k, us in ranked]
