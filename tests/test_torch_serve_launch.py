"""The port's serving surface against the reference's: the names
``repro_torch.serve`` exports, the config and report fields, the
synthetic traffic (``synth_requests`` draws the reference's requests),
and ``python -m repro_torch.launch.serve`` in a subprocess on the CPU in
batch, traffic and sweep mode (with the telemetry directory), its flags a
superset of the reference CLI's, and its refusal to run without a card
unless ``--device cpu`` is given."""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.serve as rserve
import repro.serve.scheduler as rsched
from repro.serve import traffic as rtraffic

import repro_torch.configs as tconfigs
import repro_torch.serve as tserve
import repro_torch.serve.scheduler as tsched
from repro_torch import obs
from repro_torch.models import build_model
from repro_torch.serve import KVArena, plan_kv_layout
from repro_torch.serve import traffic as ttraffic

ROOT = Path(__file__).resolve().parents[1]


def _run(*args, module="repro_torch.launch.serve", timeout=240):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, env=env, timeout=timeout, cwd=ROOT)


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_serve_exports_and_fields_equal_reference():
    assert tserve.__all__ == rserve.__all__
    for name in ("ServeConfig", "TrafficConfig", "TrafficReport"):
        assert _fields(getattr(tserve, name)) == _fields(getattr(rserve, name)), name
    for name in ("Request", "Completion", "Slot"):
        assert _fields(getattr(tsched, name)) == _fields(getattr(rsched, name)), name
    for name in ("FINISH_EOS", "FINISH_LENGTH", "FINISH_TRUNCATED", "FINISH_REJECTED"):
        assert getattr(tserve, name) == getattr(rserve, name)
    assert "serve" in dir(__import__("repro_torch"))


@pytest.mark.parametrize("seed,qps,prompt_len", [(0, 8.0, (4, 12)), (7, 2000.0, (3, 6)),
                                                 (3, 500.0, (2, 2))])
def test_synth_requests_equal_reference(seed, qps, prompt_len):
    cfg = dict(qps=qps, num_requests=16, prompt_len=prompt_len, vocab_size=128, seed=seed)
    assert ttraffic.synth_requests(ttraffic.TrafficConfig(**cfg)) == \
        rtraffic.synth_requests(rtraffic.TrafficConfig(**cfg))


def test_scheduler_equals_reference_on_a_schedule():
    """Submit, admit, finish and reject on both schedulers: the same slots,
    queue and completions."""
    t, r = tsched.Scheduler(2), rsched.Scheduler(2)
    for i, p in enumerate([[1, 2], [3], [4, 5, 6]]):
        t.submit(tsched.Request(i, p, submit_s=0.5 * i))
        r.submit(rsched.Request(i, p, submit_s=0.5 * i))
    for now in (1.0, 2.0):
        (ts, _), (rs, _) = t.next_admission(), r.next_admission()
        assert ts.index == rs.index
        assert dataclasses.asdict(t.admit(ts, now)) == dataclasses.asdict(r.admit(rs, now))
    assert t.next_admission() is None and r.next_admission() is None
    t.slots[0].tokens, r.slots[0].tokens = [7, 8], [7, 8]
    assert dataclasses.asdict(t.finish(t.slots[0], "length", 3.0)) == \
        dataclasses.asdict(r.finish(r.slots[0], "length", 3.0))
    assert dataclasses.asdict(t.reject(t.queue.popleft(), 4.0)) == \
        dataclasses.asdict(r.reject(r.queue.popleft(), 4.0))
    assert (t.pending, t.busy, len(t.active_slots)) == (r.pending, r.busy, len(r.active_slots))


def _arena_line():
    """The ``[serve] arena`` line the reference CLI prints for REDUCED
    gpt2-paper at its defaults (slots 4, max_len 128, page 16)."""
    cfg = tconfigs.get_reduced("gpt2-paper")
    lay = plan_kv_layout(build_model(cfg, device="meta").cache_specs, 128, 16)
    pages = KVArena.auto_pages(lay, 4)
    return (f"[serve] arena: {pages} pages x {lay.page_bytes()} B "
            f"({pages * lay.page_bytes() / 1e6:.1f} MB), page_size=16, "
            f"planes={list(lay.plane_dtypes)}")


def test_cli_batch_mode_on_the_cpu():
    r = _run("--reduced", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[0] == _arena_line() == \
        "[serve] arena: 32 pages x 32768 B (1.0 MB), page_size=16, planes=['float32']"
    m = re.search(r"\[serve\] 8 requests, (\d+) engine steps, [\d.]+s, [\d.]+ tok/s", r.stdout)
    assert m and int(m.group(1)) > 0
    assert re.search(r"\[serve\] prefill=\d+us/tok generate=\d+us/tok insert=\d+us", r.stdout)
    reqs = [l for l in lines if l.startswith("  req ")]
    assert len(reqs) == 4 and all(l.endswith("[length]") for l in reqs)


def test_cli_sweep_and_traffic_with_telemetry_on_the_cpu(tmp_path):
    r = _run("--reduced", "--device", "cpu", "--sweep", "4,200", "--requests", "6",
             "--max-new", "4", "--telemetry-dir", str(tmp_path / "tel"))
    assert r.returncode == 0, r.stderr[-3000:]
    reports = re.findall(r"\[serve\] qps=(\S+)\s+n=6\s+p50=.*reasons=(\{.*\})", r.stdout)
    assert [q for q, _ in reports] == ["4", "200"]
    for _, reasons in reports:
        assert sum(json.loads(reasons.replace("'", '"')).values()) == 6
    assert "[telemetry]" in r.stdout
    with open(tmp_path / "tel" / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "manifest" and kinds.count("serve_report") == 2
    assert kinds.count("serve_request") == 12
    assert all(obs.validate_event(e) == [] for e in events)

    r = _run("--reduced", "--device", "cpu", "--qps", "100", "--requests", "4",
             "--max-new", "3")
    assert r.returncode == 0, r.stderr[-3000:]
    assert re.search(r"\[serve\] qps=100\s+n=4 ", r.stdout)
    assert re.search(r"\[serve\] prefill=\d+us/tok", r.stdout)


def test_cli_flags_cover_the_reference_cli():
    def flags(text):
        return set(re.findall(r"--[a-z][a-z-]*", text))

    ref = _run("--help", module="repro.launch.serve")
    port = _run("--help")
    assert ref.returncode == 0 and port.returncode == 0
    assert flags(port.stdout) == flags(ref.stdout) | {"--device"}


def test_cli_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    r = _run("--reduced", "--requests", "1")
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr
    assert "[serve]" not in r.stdout
