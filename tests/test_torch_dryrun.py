"""The port's dry run (``repro_torch.launch.dryrun``) and its reports
(``dryrun_summary``, ``roofline_report``):

* ``plan_train``'s planned bytes for gpt2-paper at ``w8`` and ``2x8``
  equal the reference compressor's ``plan_phase`` bytes on the
  reference's plan of the same params without TP specs (built with
  ``jax.eval_shape``; no 512-device compile);
* ``auto_interval`` is the reference's rule at model world 1;
* ``memory_analysis``: the argument bytes are the bytes of a real CPU
  state; the traced peak, cut in depth and extrapolated, equals the
  full-depth trace of a training step;
* the CLI writes one JSON a combination with a status of ``ok``,
  ``does_not_fit`` or ``error``;
* ``dryrun_summary`` and ``roofline_report`` on the same hand-written
  records print the reference's text, the note column and the mesh tags
  excepted."""
import contextlib
import io
import json
import os
import sys
import types

import jax
import pytest

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.core import get_compressor as r_get_compressor
from repro.launch import dryrun_summary as r_summary
from repro.launch import roofline_report as r_roofline
from repro.models import build_model as r_build_model

import repro_torch.configs as tconfigs
from repro_torch.configs import InputShape
from repro_torch.core.ccr import HardwareSpec
from repro_torch.launch import dryrun, dryrun_summary, roofline_report
from repro_torch.optim import adamw
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.models import build_model


def _reference_by_link(arch, interval, phase, pods, intra):
    """The reference dry run's ``planned_bytes_by_link`` of a flat sync,
    on its plan of the same params without TP specs."""
    rcfg = rconfigs.get_config(arch)
    shapes = jax.eval_shape(r_build_model(rcfg).init, jax.random.PRNGKey(0))
    plan = r_build_plan(shapes, interval=interval)
    sched = r_get_compressor("covap", interval=interval).plan_phase(
        plan, phase, world=pods * intra)
    by_link = {}
    for d in (sched.exposed_bytes_by_link(), sched.deferred_bytes_by_link()):
        for link, v in d.items():
            by_link[link] = by_link.get(link, 0.0) + v
    if pods > 1:
        by_link = {"dcn": sum(by_link.values())}
    return plan.num_buckets, sched.bytes_per_worker, by_link


@pytest.mark.parametrize("mesh", ["w8", "2x8"])
@pytest.mark.parametrize("phase", [0, 1])
def test_plan_train_bytes_equal_the_reference_plan(mesh, phase):
    pods, intra = dryrun.MESHES[mesh]
    cfg = tconfigs.get_config("gpt2-paper")
    interval = dryrun.auto_interval(cfg, pods, intra)
    meta = dryrun.plan_train(cfg, pods, intra, "covap", interval, phase)
    buckets, per_worker, by_link = _reference_by_link("gpt2-paper", interval, phase,
                                                      pods, intra)
    assert meta["plan_buckets"] == buckets
    assert meta["planned_bytes_per_worker"] == per_worker > 0
    assert meta["planned_bytes_by_link"] == by_link
    assert (meta["interval"], meta["phase"], meta["compressor"], meta["sync"]) == (
        interval, phase, "covap", "allreduce")
    assert meta["collectives"]["by_kind"]["all-reduce"]["bytes"] == per_worker


def test_plan_train_w8_is_the_full_width_plan_of_the_trainer():
    """At I = 4 the w8 plan is the one ``PERF.md`` §2 states (the
    trainer's full-width gpt2-paper plan at W = 8)."""
    cfg = tconfigs.get_config("gpt2-paper")
    got = [dryrun.plan_train(cfg, 1, 8, "covap", 4, p)["planned_bytes_per_worker"]
           for p in range(4)]
    assert got == [203_701_248, 179_667_456, 179_982_336, 198_778_368]


def test_hierarchical_plan_puts_the_pod_exchange_on_dcn():
    cfg = tconfigs.get_config("gpt2-paper")
    meta = dryrun.plan_train(cfg, 2, 8, "covap", 4, 0, pod_interval=2)
    assert meta["pod_schedule"] is not None
    assert set(meta["planned_bytes_by_link"]) == {"ici", "dcn"}
    assert 0 < meta["planned_bytes_by_link"]["dcn"] < meta["planned_bytes_by_link"]["ici"]


def _reference_auto_interval():
    """``repro.launch.dryrun.auto_interval``, imported with the
    environment it rewrites restored (the backend here is already up)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as r_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return r_dryrun


@pytest.mark.parametrize("mesh", ["w8", "2x8"])
def test_auto_interval_is_the_reference_rule(mesh):
    """On the reference's own rates and a data-only mesh (model world 1),
    both pick the same interval for every arch."""
    r_dryrun = _reference_auto_interval()
    hw = r_dryrun.HW
    spec = HardwareSpec(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw, ici_bw=hw.ici_bw,
                        mfu=hw.mfu, dcn_bw=hw.dcn_bw)
    pods, intra = dryrun.MESHES[mesh]
    shape = {"pod": pods, "data": intra} if pods > 1 else {"data": intra}
    dp = tuple(shape)
    for arch in tconfigs.reference_archs():
        want = r_dryrun.auto_interval(rconfigs.get_config(arch),
                                      types.SimpleNamespace(shape=shape), dp)
        assert dryrun.auto_interval(tconfigs.get_config(arch), pods, intra, hw=spec) == want


def test_argument_bytes_are_a_real_state_and_the_cut_trace_is_exact():
    cfg = tconfigs.get_reduced("gpt2-paper").with_(num_layers=6)
    shape = InputShape("small", 32, 4, "train")
    ma = dryrun.memory_analysis(cfg, shape, 4, interval=4)
    tr = Trainer(build_model(cfg, device="cpu", seed=0), adamw(1e-4),
                 TrainConfig(interval=4, log_every=10 ** 9))
    state = tr.init_state()
    assert ma["state_size_in_bytes"] == dryrun.tree_bytes(
        [state["params"], state["opt"], state["comp"]])
    batch = dryrun.input_specs(cfg, shape, 4)
    assert ma["argument_size_in_bytes"] == ma["state_size_in_bytes"] + dryrun.tree_bytes(batch)
    assert ma["peak_traced"] == {"depths": [1, 2], "tokens": [32]}
    full = dryrun._state(cfg, shape, 4, compressor_name="covap", interval=4,
                         sync="allreduce", track=True)[3]
    assert ma["peak_memory_in_bytes"] == full > ma["argument_size_in_bytes"]
    assert ma["fits"]


def test_token_loop_family_is_cut_in_length_too():
    cfg = tconfigs.get_reduced("xlstm-125m")
    peak, traced = dryrun.traced_peak(cfg, InputShape("t", 64, 2, "train"), 2,
                                      compressor_name="covap", interval=4,
                                      sync="allreduce")
    assert traced == {"depths": [1], "tokens": list(dryrun.TRACE_TOKENS)}
    assert peak > 0


def test_cli_writes_one_record_a_combination(tmp_path):
    out = tmp_path / "d"
    assert dryrun.main(["--arch", "gpt2-paper,qwen1.5-0.5b", "--shape",
                        "decode_32k,long_500k", "--mesh", "both", "--device", "cpu",
                        "--out", str(out)]) == 0
    recs = dryrun_summary.load(str(out))
    assert len(recs) == 8
    for r in recs:
        assert r["status"] in ("ok", "does_not_fit", "error")
        assert r["status"] != "error", r.get("traceback")
        assert r["n_devices"] == (8 if r["mesh"] == "w8" else 16)
        ma = r["memory_analysis"]
        assert ma["fits"] == (r["status"] == "ok")
        assert ma["argument_size_in_bytes"] > r["arena_bytes"] > 0
        assert r["roofline"]["collective_s"] == 0.0
    text = dryrun_summary.table(recs)
    assert text.count("\n") == 2 + len(recs) - 1
    assert "### Mesh 2x8" in roofline_report.report(recs)


def test_dryrun_asks_for_the_card_by_default():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--arch", "gpt2-paper", "--shape", "long_500k"])


# hand-written records, one per mesh tag pair
def _records(mesh1, mesh2):
    def rec(arch, shape, mesh, kind, status, compute, memory, coll, ratio):
        return {"arch": arch, "shape": shape, "mesh": mesh, "kind": kind,
                "status": status, "compile_s": 1.5,
                "memory_analysis": {"peak_memory_in_bytes": 3.2e10,
                                    "argument_size_in_bytes": 1.1e10},
                "collectives": {"by_kind": {"all-reduce": {"count": 35, "bytes": 2.0e8},
                                            "all-gather": {"count": 2, "bytes": 1e6}}},
                "roofline": {"compute_s": compute, "memory_s": memory,
                             "collective_s": coll, "dominant": max(
                                 (("compute", compute), ("memory", memory),
                                  ("collective", coll)), key=lambda t: t[1])[0],
                             "useful_flops_ratio": ratio}}
    return [
        rec("gpt2-paper", "train_4k", mesh1, "train", "ok", 0.2, 0.05, 0.3, 0.97),
        rec("gpt2-paper", "decode_32k", mesh1, "decode", "ok", 0.001, 0.01, 0.0, None),
        rec("qwen1.5-0.5b", "prefill_32k", mesh1, "prefill", "ok", 0.3, 0.02, 0.0, 0.9),
        rec("qwen1.5-0.5b", "train_4k", mesh2, "train", "ok", 0.4, 0.05, 0.1, 0.95),
        {"arch": "grok-1-314b", "shape": "train_4k", "mesh": mesh1, "status": "timeout"},
    ]


def _write(tmp_path, name, recs):
    d = tmp_path / name
    d.mkdir()
    for i, r in enumerate(recs):
        (d / f"{i}.json").write_text(json.dumps(r))
    return str(d)


def _printed(main, argv):
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = ["x", *argv]
    try:
        with contextlib.redirect_stdout(buf):
            main()
    finally:
        sys.argv = saved
    return buf.getvalue()


def _drop_note(text):
    return "\n".join("|".join(line.split("|")[:-2]) if line.startswith("|") else line
                     for line in text.splitlines())


def test_reports_print_the_reference_text(tmp_path):
    ref_dir = _write(tmp_path, "ref", _records("16x16", "2x16x16"))
    port_dir = _write(tmp_path, "port", _records("w8", "2x8"))
    for ref_main, port_main in ((r_summary.main, dryrun_summary.main),
                                (r_roofline.main, roofline_report.main)):
        want = _printed(ref_main, ["--dir", ref_dir])
        got = _printed(port_main, ["--dir", port_dir])
        want = want.replace("2x16x16", "2x8").replace("16x16", "w8")
        assert _drop_note(got) == _drop_note(want)
    # the note names the card's tensor cores, no TPU part
    assert "MXU" not in roofline_report.one_liner(_records("w8", "2x8")[2])
