"""The readers of moonlight's cell on small hand-built traces: latent
attention's two spans (read with ``mla/`` among the program's spans, the
frozen readers' spans left as they were), an autograd-thread launch inside
the recompute's ``mla/attend`` counted, nothing read where the spans are
absent; ``moe.held_frac`` from the program's counters, absent where no
layer holds a share; and a traced run of the cell at its small size that
reads all three."""
from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench import harness
from bench.yardstick import spans as frozen
from bench.yardstick.trace import TraceView

CELL = "moonlight-16b-a3b-5L-e32.covap.r2s8k"


def ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def launch(ts, corr, tid=1):
    return ev("cudaLaunchKernel", "cuda_runtime", ts, 1, tid=tid, corr=corr)


def one_step():
    """One 100 us step: the forward pass launches, in ``mla/latent``, a
    GEMM (10-20) and, in ``mla/attend``, a softmax (20-30); the autograd
    thread (2), under the stepping thread's ``train/backward``, launches
    in its own ``mla/attend`` (the recompute) a softmax (40-45), and
    outside it a GEMM (50-60)."""
    t = [
        ev("bench/step", "user_annotation", 0, 100),
        ev("train/forward", "user_annotation", 5, 25),
        ev("mla/latent", "user_annotation", 6, 2),
        ev("mla/attend", "user_annotation", 8, 3),
        ev("train/backward", "user_annotation", 30, 40),
        ev("mla/attend", "user_annotation", 34, 2, tid=2),
        launch(7, 1), launch(9, 2), launch(35, 3, tid=2), launch(37, 4, tid=2),
        ev("sm90_xmma_gemm_bf16", "kernel", 10, 10, tid=7, corr=1),
        ev("softmax_warp_forward", "kernel", 20, 10, tid=7, corr=2),
        ev("softmax_warp_forward", "kernel", 40, 5, tid=7, corr=3),
        ev("sm90_xmma_gemm_bf16", "kernel", 50, 10, tid=7, corr=4),
    ]
    return TraceView(t, steps=[{"phase": 0, "ef_bytes": 0}], window_us=100.0,
                     context={"flops_per_step": 1.0, "chips": 1, "untraced_steps": 1,
                              "untraced_s": 1e-4})


EXPECTED = {"mla.latent_ms": 0.010, "mla.attend_ms": 0.015}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_latent_span_readers_on_a_small_trace(name):
    saved = frozen.PREFIXES
    v = one_step()
    assert harness.reader(name)(v) == pytest.approx(EXPECTED[name])
    assert frozen.PREFIXES == saved
    # the frozen readers' spans read as before, the latent ones not among them
    assert harness.reader("model.forward_ms")(v) == pytest.approx(0.020)
    assert "mla/latent" not in frozen.Spans(v).present


@pytest.mark.parametrize("name", sorted(EXPECTED) + ["moe.held_frac"])
def test_the_readers_read_nothing_without_their_spans_or_counters(name):
    from repro_torch.obs import spans

    spans.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        spans.count("moe/assigned", 96)
        spans.count("moe/dropped", torch.tensor(0))
    v = TraceView([ev("bench/step", "user_annotation", 0, 100), launch(5, 1),
                   ev("sm90_xmma_gemm_bf16", "kernel", 10, 10, tid=7, corr=1)],
                  steps=[{"phase": 0}], window_us=100.0, context={})
    assert harness.reader(name)(v) is None
    spans.reset_counters()


def test_held_frac_reads_the_program_counters():
    from repro_torch.obs import spans

    read = harness.reader("moe.held_frac")
    spans.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            spans.count("moe/assigned", 96)
            spans.count("moe/held", torch.tensor(50))
    assert read(one_step()) == pytest.approx(100 / 192)
    spans.reset_counters()


def test_a_traced_run_of_the_cell_reads_its_held_share(small, port):
    from repro_torch.obs import spans

    spans.reset_counters()
    out = harness.run_rank(small(cell=CELL), seed=2**31 + 37, seconds=0.0, trace=True, rank=0,
                           world=1, port=port, device="cpu", t_start=0.0)
    spans.reset_counters()
    assert out["correct"], out["checks"]
    assert 0.3 < out["metrics"]["moe.held_frac"] < 0.7
    # no device on the CPU: the span readers find nothing to read
    assert "mla.attend_ms" not in out["metrics"]
