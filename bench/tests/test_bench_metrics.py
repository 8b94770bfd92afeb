"""The benchmark's frozen metric arithmetic on the CPU: the trace reader on
small hand-built traces, every per-layer reader, the step's FLOPs against
the port's closed form, and the EF pass's bytes; the two first cells'
FLOPs, bucket plans and EF bytes pinned."""
from __future__ import annotations

import math

import pytest

from bench_cells import WORKLOADS

from bench import harness, reference
from bench.yardstick import ef_bytes
from bench.yardstick.trace import TraceView, kernel_group, length, union


def ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def two_steps():
    """Two steps of 100 us on thread 1, a loader span and one stream sync
    each (the first loader span also holds a copy call): step 0 launches
    gemms at 10-30 and 50-60 and, from a bucket span on thread 2, an EF
    kernel at 40-45; step 1 a gemm at 110-120, an NCCL
    kernel at 120-140 and a copy under it at 125-130."""
    t = [
        ev("bench/step", "user_annotation", 0, 100), ev("bench/step", "user_annotation", 100, 100),
        ev("bench/loader", "user_annotation", 1, 4), ev("bench/loader", "user_annotation", 101, 6),
        ev("cudaMemcpyAsync", "cuda_runtime", 2, 1), ev("cudaStreamSynchronize", "cuda_runtime", 3, 1),
        ev("cudaStreamSynchronize", "cuda_runtime", 102, 1),
        ev("aten::mm", "cpu_op", 5, 10), ev("cudaLaunchKernel", "cuda_runtime", 6, 1, corr=1),
        ev("cudaLaunchKernel", "cuda_runtime", 8, 1, corr=6),
        ev("covap_bucket_3/phase_0", "user_annotation", 20, 10, tid=2),
        ev("cudaLaunchKernel", "cuda_runtime", 21, 1, tid=2, corr=2),
        ev("cuLaunchKernel", "cuda_driver", 106, 1, corr=3),
        ev("ncclDevKernel_AllReduce launch", "cuda_runtime", 108, 1, corr=4),
        ev("cudaLaunchKernel", "cuda_runtime", 109, 1, corr=5),
        ev("sm90_xmma_gemm_bf16", "kernel", 10, 20, corr=1),
        ev("ef_update_kernel", "kernel", 40, 5, corr=2),
        ev("sm90_xmma_gemm_bf16", "kernel", 50, 10, corr=6),
        ev("sm90_xmma_gemm_bf16", "kernel", 110, 10, corr=3),
        ev("ncclDevKernel_AllReduce_Sum_f32", "kernel", 120, 20, corr=4),
        ev("vectorized_elementwise_kernel copy", "kernel", 125, 5, corr=5),
        ev("aten::copy_", "cpu_op", 135, 55),
    ]
    steps = [{"phase": 0, "ef_bytes": 3_350_000}, {"phase": 1, "ef_bytes": 0}]
    ctx = {"flops_per_step": 1e12, "chips": 2, "untraced_steps": 10, "untraced_s": 2.0}
    return TraceView(t, steps=steps, window_us=200.0, context=ctx)


def test_intervals():
    assert union([(5, 7), (0, 2), (1, 3)]) == [(0, 3), (5, 7)]
    assert length([(0, 2), (1, 3), (5, 7)]) == 5


def test_kernel_groups():
    assert kernel_group("sm90_xmma_gemm_bf16bf16_bf16f32") == "matmul"
    assert kernel_group("ef_update_kernel(float const*)") == "ef_update"
    assert kernel_group("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "nccl"
    assert kernel_group("void at::native::vectorized_elementwise_kernel<4>") == "elementwise/reduce"
    assert kernel_group("mystery") == "other"


def test_trace_view_counts():
    v = two_steps()
    assert v.busy_us() == 20 + 5 + 10 + 10 + 20
    assert [len(k) for k in v.kernels_by_step] == [3, 3]
    groups = dict(v.top_groups())
    assert groups["matmul"] == pytest.approx(20e-6)
    gaps = dict(v.idle_gaps())
    # device idle inside the steps: 0-10, 30-40, 45-50, 60-100 (step 0),
    # 100-110, 140-200 (step 1)
    assert sum(gaps.values()) == pytest.approx((10 + 10 + 5 + 40 + 10 + 60) / 1e6 / 2)
    assert "aten::copy_" in gaps


EXPECTED = {
    # the loader spans' 4 and 6 us less their copy and sync calls' 2 and 1
    "data.loader_ms": 0.0035,
    "trainer.launches_per_step": 2.5,
    "trainer.host_syncs_per_step": 1.0,
    "model.gemm_ms": 0.02,
    "sync.ef_update_roofline": 100.0 * (3_350_000 / 3.35e12) / 5e-6,
    "device.idle_frac": 1 - (65e-6 / 2) / (2.0 / 10),
    "device.mfu": 100.0 * 1e13 / 2.0 / (989.4e12 * 2),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_every_reader_on_a_small_trace(name):
    assert harness.reader(name)(two_steps()) == pytest.approx(EXPECTED[name])


def test_every_metric_has_a_reader():
    import json

    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    readers = {p.stem for p in (harness.BENCH / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in spec["per_layer"]}
    assert set(EXPECTED) <= readers


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_readers_read_nothing_from_an_empty_trace(name):
    steps = [{"phase": 0, "ef_bytes": 100}]
    v = TraceView([ev("bench/step", "user_annotation", 0, 100)], steps=steps, window_us=100.0,
                  context={"flops_per_step": 1.0, "chips": 1, "untraced_steps": 0,
                           "untraced_s": 0.0})
    assert harness.reader(name)(v) is None


@pytest.mark.parametrize("name", WORKLOADS)
def test_step_flops_equal_the_port(name):
    import dataclasses

    from repro_torch.configs.base import ArchConfig, InputShape
    from repro_torch.launch.analytic_costs import step_flops

    cell = harness.load_cell(name)
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    port_cfg = ArchConfig(**{k: v for k, v in cell.conf.items() if k in fields})
    rows, seq = cell.traffic["rows_per_chip"] * cell.chips, cell.traffic["seq_len"]
    want = step_flops(port_cfg, InputShape("x", seq, rows, "train"))
    got = reference.of(cell.conf).step_flops(cell.conf, rows=rows, seq_len=seq)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", WORKLOADS)
def test_ef_bytes_count_every_element_once(name):
    cell = harness.load_cell(name)
    interval = cell.traffic["interval"]
    buckets, shapes = ef_bytes.plan_of(cell.conf, cell.traffic)
    total = sum(math.prod(s) for s in shapes)
    per_phase = [ef_bytes.ef_bytes(buckets, shapes, p, interval) for p in range(interval)]
    # every element is selected in exactly one of the phases
    assert sum(per_phase) == total * (16 + (interval - 1) * 12)
    assert all(12 * total < b < 16 * total for b in per_phase)


# what the two first cells read, as computed before the reference was looked
# up by configuration: the step's FLOPs at 8 rows of 1024 tokens, the
# buckets, each phase's EF bytes, the parameters
PINNED = {
    "gpt2-paper.covap.b8": (7_929_046_499_328, 35, [2_490_089_472, 2_466_055_680,
                                                    2_466_370_560, 2_485_166_592],
                            190_532_352),
    "deepseek-moe-16b-2L.covap.b8": (18_979_460_481_024, 66,
                                     [20_752_916_480, 20_726_505_472, 20_726_505_472,
                                      20_742_209_536], 1_595_156_480),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_first_cells_read_what_they_read_before(name):
    flops, n_buckets, per_phase, params = PINNED[name]
    cell = harness.load_cell(name)
    assert reference.of(cell.conf).step_flops(cell.conf, rows=8, seq_len=1024) == flops
    buckets, shapes = ef_bytes.plan_of(cell.conf, cell.traffic)
    assert len(buckets) == n_buckets
    assert sum(math.prod(s) for s in shapes) == params
    assert [ef_bytes.ef_bytes(buckets, shapes, p, 4) for p in range(4)] == per_phase
