"""The port's trace analysis (``repro_torch.launch.hlo_analysis``): its
pure parts against ``repro.launch.hlo_analysis`` on the same inputs (the
roofline terms, ``group_link``, the wire model of ``collective_summary``,
the per-worker and per-link byte normalisation), and its readers of a
``torch.profiler`` trace on hand-written and recorded events.  The 2-rank
profiled steps are in ``tests/test_torch_gates.py``."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.launch import hlo_analysis as ref

from repro_torch.launch import hlo_analysis as ha

# one module's collectives, as XLA prints them and as a profiled step
# records them: an f32 all-reduce of 16384 elements and a bf16 one of 10 (a
# metric), an all-gather of a 4096-element shard and a reduce-scatter of a
# 4096-element buffer, over two workers, and a cross-pod all-reduce
HLO = """\
ENTRY %main (p: f32[16384]) -> f32[16384] {
  %p = f32[16384]{0} parameter(0)
  %all-reduce.1 = f32[16384]{0} all-reduce(f32[16384]{0} %p), replica_groups={{0,1},{2,3}}, to_apply=%add
  %all-reduce.2 = bf16[10]{0} all-reduce(bf16[10]{0} %p), replica_groups={{0,1},{2,3}}, to_apply=%add
  %all-gather.3 = f32[8192]{0} all-gather(f32[4096]{0} %p), replica_groups={{0,1},{2,3}}, dimensions={0}
  %reduce-scatter.4 = f32[2048]{0} reduce-scatter(f32[4096]{0} %p), replica_groups={{0,1},{2,3}}, dimensions={0}
  %all-reduce.5 = f32[1024]{0} all-reduce(f32[1024]{0} %p), replica_groups={{0,2},{1,3}}, to_apply=%add
}
"""


def _ev(name, ts, dur=1.0, cat="cpu_op", tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _span(link, dtype, ts, dur=5.0):
    return _ev(f"collective/{link}/{dtype}", ts, dur, cat="user_annotation")


TRACE = [
    _span("ici", "float32", 10),
    _ev("c10d::allreduce_", 11, **{"Input Dims": [[[16384]], [], []],
                                   "Input type": ["TensorList", "", ""]}),
    _span("ici", "bfloat16", 20),
    _ev("c10d::allreduce_", 21, **{"Input Dims": [[[10]], [], []],
                                   "Input type": ["TensorList", "", ""]}),
    _span("ici", "float32", 30),
    _ev("c10d::_allgather_base_", 31, **{"Input Dims": [[8192], [4096], []],
                                         "Input type": ["float", "float", ""]}),
    _span("ici", "float32", 40),
    _ev("c10d::_reduce_scatter_base_", 41, **{"Input Dims": [[2048], [4096], []],
                                              "Input type": ["float", "float", ""]}),
    _span("dcn", "float32", 50),
    _ev("c10d::allreduce_", 51, **{"Input Dims": [[[1024]], [], []],
                                   "Input type": ["TensorList", "", ""]}),
]


def test_roofline_terms_equal_reference():
    kw = dict(flops_per_device=3.1e15, hbm_bytes_per_device=7.7e11,
              wire_bytes_per_device=2.9e9, peak_flops=989.4e12, hbm_bw=3.35e12,
              ici_bw=450e9)
    got, want = ha.roofline_terms(**kw), ref.roofline_terms(**kw)
    assert (got.compute_s, got.memory_s, got.collective_s) == (
        want.compute_s, want.memory_s, want.collective_s)
    assert got.dominant == want.dominant and got.bound_s == want.bound_s
    for terms in ((1.0, 2.0, 0.5), (0.1, 0.2, 3.0), (4.0, 0.0, 0.0)):
        g, w = ha.RooflineTerms(*terms), ref.RooflineTerms(*terms)
        assert (g.dominant, g.bound_s) == (w.dominant, w.bound_s)


def test_roofline_defaults_are_the_h100():
    t = ha.roofline_terms(flops_per_device=989.4e12, hbm_bytes_per_device=3.35e12,
                          wire_bytes_per_device=450e9)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 1.0, 1.0)


@pytest.mark.parametrize("group,intra", [([0, 1], 2), ([0, 2], 2), ([3, 4], 4),
                                         ([0, 8], 8), ([5], 1), ([0, 1, 2, 3], 4)])
def test_group_link_equals_reference(group, intra):
    assert ha.group_link(group, intra) == ref.group_link(group, intra)


def test_collective_summary_and_wire_model_equal_reference():
    got, want = ha.collective_summary(TRACE), ref.collective_summary(HLO, trip_aware=False)
    assert got["ops"] == want["ops"]
    assert got["by_kind"] == want["by_kind"]
    assert got["buffer_bytes"] == want["buffer_bytes"]
    assert got["wire_bytes_est"] == want["wire_bytes_est"]
    by_kind = {k: v["bytes"] for k, v in got["by_kind"].items()}
    assert ha.wire_bytes_est(by_kind) == want["wire_bytes_est"]


def test_bytes_per_worker_and_by_link_equal_reference():
    assert ha.collective_bytes_per_worker(TRACE, 2) == ref.collective_bytes_per_worker(HLO, 2)
    got = ha.collective_bytes_by_link(TRACE, intra_world=2, min_bytes=100, world=4)
    want = ref.collective_bytes_by_link(HLO, intra_world=2, min_bytes=100, world=4)
    assert got == want
    assert got["dcn"] == 4096          # the {0,2} group crosses the pods
    assert ha.collective_bytes_per_worker(TRACE, 2, min_bytes=100) == (
        ha.collective_bytes_per_worker(TRACE, 2) - 20)


def test_parse_reads_group_size_from_shapes_and_needs_a_dtype():
    ops = ha.parse_collectives(TRACE)
    assert [op.kind for op in ops] == ["all-reduce", "all-reduce", "all-gather",
                                       "reduce-scatter", "all-reduce"]
    assert [op.result_bytes for op in ops] == [65536, 20, 32768, 8192, 4096]
    assert [op.group_size for op in ops] == [0, 0, 2, 2, 0]
    assert [op.link for op in ops] == ["ici"] * 4 + ["dcn"]
    with pytest.raises(ValueError, match="count_collectives"):
        ha.parse_collectives(TRACE[1:2])


def _interleaved_trace(issue_at):
    """Two backward products at 100 and 200 and a bucket collective issued
    at each of ``issue_at``, plus a forward product outside the backward."""
    ev = [_ev("aten::mm", 5),
          _ev("autograd::engine::evaluate_function: MmBackward0", 99, 10),
          _ev("aten::mm", 100),
          _ev("autograd::engine::evaluate_function: MmBackward0", 199, 10),
          _ev("aten::mm", 200)]
    for t in issue_at:
        ev += [_span("ici", "float32", t), _ev("c10d::allreduce_", t + 1, **{
            "Input Dims": [[[4096]], [], []], "Input type": ["TensorList", "", ""]})]
    return sorted(ev, key=lambda e: e["ts"])


def test_interleaving_on_hand_written_traces():
    fused = ha.check_interleaving(_interleaved_trace([150, 300]))
    assert fused.interleaved and fused.num_grad_ops == 2
    assert (fused.num_collectives, fused.before_final_grad, fused.independent) == (2, 1, 1)
    assert (fused.first_collective_pos, fused.last_grad_pos) == (1, 2)
    assert (fused.device_early, fused.device_buckets) == (-1, -1)
    post = ha.check_interleaving(_interleaved_trace([300, 310]))
    assert not post.interleaved and post.before_final_grad == 0
    small = ha.check_interleaving(_interleaved_trace([150]), min_bytes=1 << 20)
    assert small.num_collectives == 0 and not small.interleaved


def test_sharded_placement_on_a_hand_written_trace():
    ev = _interleaved_trace([])
    ag = {"Input Dims": [[8192], [4096], []], "Input type": ["float", "float", ""]}
    rs = {"Input Dims": [[2048], [4096], []], "Input type": ["float", "float", ""]}
    ev += [_ev("c10d::_allgather_base_", 1, **ag), _ev("c10d::_allgather_base_", 2, **ag),
           _ev("c10d::_reduce_scatter_base_", 150, **rs),
           _ev("c10d::_reduce_scatter_base_", 250, **rs)]
    ev.sort(key=lambda e: e["ts"])
    r = ha.check_sharded_placement(ev, min_bytes=8192, world=2)
    assert r.placed
    assert (r.num_all_gather, r.num_reduce_scatter, r.rs_before_final_grad,
            r.ag_before_first_rs) == (2, 2, 1, 2)
    # a reduce-scatter's shard filters at min_bytes / world
    assert ha.check_sharded_placement(ev, min_bytes=8192 * 4, world=2).num_reduce_scatter == 0


def test_data_movement_and_op_counts():
    ev = [_ev("aten::copy_", 1), _ev("aten::cat", 2), _ev("aten::slice", 3),
          _ev("aten::copy_", 4), _ev("Memcpy DtoD (Device -> Device)", 5, cat="gpu_memcpy"),
          _ev("Memcpy HtoD (Pageable -> Device)", 6, cat="gpu_memcpy")]
    got = ha.count_data_movement(ev)
    assert got["aten::copy_"] == 2 and got["aten::cat"] == 1
    assert got[ha.DEVICE_COPY] == 1 and got["total"] == 4
    d = ha.data_movement_delta(ev, ev[:2])
    assert d["delta"]["total"] == 2
    assert ha.count_hlo_ops(ev, ["aten::copy_", "aten::slice", "aten::sl"]) == {
        "aten::copy_": 2, "aten::slice": 1, "aten::sl": 0}


def test_backward_products_of_a_recorded_trace():
    """``load_trace`` reads a real profile; the backward pass's
    matrix products are found under autograd, the forward's are not."""
    a = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(16, 4, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        (a @ w).sum().backward()
    trace = ha.load_trace(prof)
    grads = ha.grad_ops(trace)
    assert len(grads) == 2 and {e["name"] for e in grads} == {"aten::mm"}
    forward = [e for e in trace if e["name"] == "aten::mm" and e not in grads]
    assert len(forward) == 1 and forward[0]["ts"] < min(e["ts"] for e in grads)
