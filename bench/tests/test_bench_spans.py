"""The readers of the program's spans and counters
(``bench.yardstick.spans``) on small hand-built traces: an autograd-thread
launch under the stepping thread's ``train/backward``, the fused overlap's
bucket kernels left out of the backward pass, a ``gpu_user_annotation``
ignored, nothing read where a span is absent; the MoE counters; every metric of ``BENCHMARK.json``
with a reader."""
from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench import harness
from bench.yardstick.trace import TraceView


def ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def launch(ts, corr, tid=1):
    return ev("cudaLaunchKernel", "cuda_runtime", ts, 1, tid=tid, corr=corr)


def one_step(extra=()):
    """One 100 us step on thread 1 (the autograd engine's thread is 2):
    the forward pass launches a GEMM (10-20) and, in its ``moe/dispatch``
    span, a cumsum (20-25); thread 2 launches, under thread 1's
    ``train/backward``, a GEMM (40-50) and a second one (60-70), and in a
    bucket span an EF kernel (55-58) and an NCCL all-reduce (60-80); the
    optimizer an elementwise kernel (85-90); the metrics an NCCL
    all-reduce (96-99) outside every bucket span; a ``gpu_user_annotation``
    named ``train/optimizer`` covers the whole step on the device's row."""
    t = [
        ev("bench/step", "user_annotation", 0, 100),
        ev("train/forward", "user_annotation", 5, 25),
        ev("moe/dispatch", "user_annotation", 7, 3),
        ev("train/backward", "user_annotation", 30, 40),
        ev("covap_bucket_0/phase_0", "user_annotation", 52, 8, tid=2),
        ev("train/sync", "user_annotation", 70, 10),
        ev("train/optimizer", "user_annotation", 80, 15),
        ev("train/metrics", "user_annotation", 95, 4),
        ev("train/optimizer", "gpu_user_annotation", 0, 100, tid=7),
        launch(6, 1), launch(8, 8),
        launch(35, 2, tid=2), launch(36, 6, tid=2),
        launch(53, 3, tid=2),
        ev("ncclDevKernel_AllReduce launch", "cuda_runtime", 54, 1, tid=2, corr=4),
        launch(81, 7), launch(96, 9),
        ev("sm90_xmma_gemm_bf16", "kernel", 10, 10, tid=7, corr=1),
        ev("cumsum_kernel", "kernel", 20, 5, tid=7, corr=8),
        ev("sm90_xmma_gemm_bf16", "kernel", 40, 10, tid=7, corr=2),
        ev("ef_update_kernel", "kernel", 55, 3, tid=8, corr=3),
        ev("sm90_xmma_gemm_bf16", "kernel", 60, 10, tid=7, corr=6),
        ev("ncclDevKernel_AllReduce_Sum_f32", "kernel", 60, 20, tid=9, corr=4),
        ev("vectorized_elementwise_kernel", "kernel", 85, 5, tid=7, corr=7),
        ev("ncclDevKernel_AllReduce_Sum_f32", "kernel", 96, 3, tid=9, corr=9),
        *extra,
    ]
    return TraceView(t, steps=[{"phase": 0, "ef_bytes": 0}], window_us=100.0,
                     context={"flops_per_step": 1.0, "chips": 1, "untraced_steps": 1,
                              "untraced_s": 1e-4})


EXPECTED = {
    # the GEMM and the cumsum
    "model.forward_ms": 0.015,
    # both GEMMs of thread 2, launched while thread 1 waits in the backward
    # pass; the bucket's EF and NCCL kernels left out
    "model.backward_ms": 0.020,
    "optim.adamw_ms": 0.005,
    "moe.dispatch_ms": 0.005,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_readers_on_a_small_trace(name):
    assert harness.reader(name)(one_step()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_readers_read_nothing_without_their_spans(name):
    v = TraceView([ev("bench/step", "user_annotation", 0, 100),
                   ev("train/optimizer", "gpu_user_annotation", 0, 100, tid=7),
                   launch(5, 1), ev("sm90_xmma_gemm_bf16", "kernel", 10, 10, tid=7, corr=1)],
                  steps=[{"phase": 0}], window_us=100.0, context={})
    assert harness.reader(name)(v) is None


def test_a_launch_outside_the_profiled_steps_counts_nowhere():
    late = [ev("train/optimizer", "user_annotation", 150, 10), launch(151, 20),
            ev("vectorized_elementwise_kernel", "kernel", 152, 5, tid=7, corr=20)]
    assert harness.reader("optim.adamw_ms")(one_step(late)) == pytest.approx(0.005)


def test_a_launch_on_the_autograd_thread_outside_the_backward_pass_is_not_in_it():
    early = [launch(2, 21, tid=2),
             ev("sm90_xmma_gemm_bf16", "kernel", 3, 2, tid=7, corr=21)]
    v = one_step(early)
    assert harness.reader("model.backward_ms")(v) == pytest.approx(0.020)
    assert harness.reader("model.forward_ms")(v) == pytest.approx(0.015)


def test_dropped_frac_reads_the_program_counters():
    from repro_torch.obs import spans

    read = harness.reader("moe.dropped_frac")
    spans.reset_counters()
    assert read(one_step()) is None
    with profile(activities=[ProfilerActivity.CPU]):
        spans.count("moe/assigned", 96)
        spans.count("moe/dropped", torch.tensor(6))
        spans.count("moe/assigned", 96)
        spans.count("moe/dropped", torch.tensor(6))
    assert read(one_step()) == pytest.approx(12 / 192)
    spans.reset_counters()


def test_every_metric_has_a_reader_file():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    readers = {p.stem for p in (harness.BENCH / "metrics").glob("*.py")}
    assert {m["name"] for m in spec["per_layer"]} == readers
    assert set(EXPECTED) | {"moe.dropped_frac"} <= readers


def test_a_traced_moe_run_reads_its_dropped_share(small, port):
    from repro_torch.obs import spans

    spans.reset_counters()
    out = harness.run_rank(small("deepseek-moe-16b-2L"), seed=2**31 + 7, seconds=0.0,
                           trace=True, rank=0, world=1, port=port, device="cpu",
                           t_start=0.0)
    spans.reset_counters()
    assert out["correct"]
    assert 0.0 <= out["metrics"]["moe.dropped_frac"] < 1.0
