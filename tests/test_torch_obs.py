"""The port's telemetry bundle (``repro_torch.obs``) against ``repro.obs``:

* the port's ``event_schema.json`` parses equal to the reference's, and
  ``validate_event`` gives the same errors on the same events;
* ``plan_digest`` is the same on the same plan (REDUCED and full width,
  several intervals);
* the metrics registry gives the same snapshot and Prometheus text after
  the same instrument calls (made from a numpy seed);
* ``EventLog`` with a fixed clock and run id writes the same records;
* ``Telemetry.save`` writes the four artifacts, ``as_telemetry`` coerces
  as the reference's, and the disabled singletons stay disabled;
* ``Trainer.run(telemetry=...)`` writes a manifest and step records that
  validate against the schema, and leaves the run bitwise as without it."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.obs as robs
from repro.core import build_plan as r_build_plan
from repro.models import build_model as r_build_model

import repro_torch.configs as tconfigs
import repro_torch.obs as obs
from repro_torch import optim
from repro_torch.core import build_plan
from repro_torch.data import DataConfig, make_loader
from repro_torch.models import build_model
from repro_torch.train import TrainConfig, Trainer

torch.set_num_threads(2)

EVENTS = [
    {"ts": 1.0, "kind": "step", "run_id": "r", "step": 3, "loss": 2.5, "wall_s": 0.1},
    {"ts": 1.0, "kind": "step", "run_id": "r", "step": 3.0, "loss": 2.5, "wall_s": 0.1},
    {"ts": 1.0, "kind": "step", "run_id": "r", "step": True, "loss": "x"},
    {"ts": 1.0, "kind": "probe", "run_id": "r", "step": 1, "phase": 0, "t_comp": 0.1,
     "t_comm": 0.0, "ccr": 0.0, "achieved_overlap": None},
    {"ts": 1.0, "kind": "probe", "run_id": "r", "step": 1, "phase": 0, "t_comp": 0.1,
     "t_comm": 0.0, "ccr": 0.0, "achieved_overlap": "1"},
    {"ts": 1.0, "kind": "replan_decision", "run_id": "r", "step": 1, "interval": 2,
     "replan": False, "reason": "in-band", "measured_ccr": None, "pending": 0},
    {"ts": 1.0, "kind": "replan", "run_id": "r", "step": 1, "old_interval": 4,
     "new_interval": 2, "reason": "x", "policy": "carry"},
    {"ts": 1.0, "kind": "nope", "run_id": "r"},
    {"kind": "note"},
    {"ts": 1.0, "kind": "note", "run_id": "r", "message": 3, "extra": 1},
    "not an event",
]


def test_schema_copy_parses_equal_to_reference():
    with open(obs.SCHEMA_PATH) as f, open(robs.SCHEMA_PATH) as g:
        assert json.load(f) == json.load(g)
    assert obs.load_schema() == robs.load_schema()
    assert os.path.dirname(obs.SCHEMA_PATH).endswith(os.path.join("repro_torch", "obs"))


@pytest.mark.parametrize("i", range(len(EVENTS)))
def test_validate_event_equals_reference(i):
    assert obs.validate_event(EVENTS[i]) == robs.validate_event(EVENTS[i])


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("interval", [1, 2, 4, 8])
def test_plan_digest_equals_reference(reduced, interval):
    cfg = (rconfigs.get_reduced if reduced else rconfigs.get_config)("gpt2-paper")
    shapes = jax.eval_shape(r_build_model(cfg).init, jax.random.PRNGKey(0))
    model = build_model((tconfigs.get_reduced if reduced else tconfigs.get_config)
                        ("gpt2-paper"), device="meta")
    kw = (dict(bucket_bytes=1 << 14, max_buckets=32) if reduced
          else dict(bucket_bytes=25 << 20, max_buckets=128))
    got = obs.plan_digest(build_plan(model.named_leaves(), interval=interval, **kw))
    assert got == robs.plan_digest(r_build_plan(shapes, interval=interval, **kw))
    assert len(got) == 16


def _drive_registry(reg, seed):
    rng = np.random.default_rng(seed)
    c = reg.counter("steps_total", "steps")
    g = reg.gauge("loss", "last loss")
    for i in range(20):
        c.inc()
        g.set(float(rng.normal()))
        reg.histogram("step_s", "step seconds", phase=str(i % 3)).observe(
            float(rng.uniform(0, 1)))
        reg.counter("bytes_total", "bytes", link='ic"i\n').inc(float(rng.integers(0, 99)))
    reg.gauge("never_set", "planned, never measured")
    reg.histogram("empty", "")
    return reg


@pytest.mark.parametrize("seed", range(3))
def test_registry_equals_reference(seed):
    got = _drive_registry(obs.MetricsRegistry(hist_window=8), seed)
    want = _drive_registry(robs.MetricsRegistry(hist_window=8), seed)
    assert got.snapshot() == want.snapshot()
    assert got.to_prometheus_text() == want.to_prometheus_text()
    with pytest.raises(ValueError, match="already registered as counter"):
        got.gauge("steps_total")
    off = _drive_registry(obs.MetricsRegistry(enabled=False), seed)
    assert off.snapshot() == {} and off.counter("x") is obs.NULL_INSTRUMENT
    assert obs.NULL_REGISTRY.snapshot() == {}


def test_event_log_equals_reference(tmp_path):
    logs = []
    for mod, name in ((obs, "port"), (robs, "ref")):
        path = str(tmp_path / name / "events.jsonl")
        log = mod.EventLog(path, run_id="run-1", clock=lambda: 1.5)
        log.emit("probe", step=2, phase=1, t_comp=0.1, t_comm=0.02, ccr=0.2,
                 achieved_overlap=None)
        log.emit("note", message="x", payload={"a": (1, 2), "b": np.float32(1)})
        with pytest.raises(ValueError, match="invalid 'step' event"):
            log.emit("step", step=1)
        log.close()
        with open(path) as f:
            logs.append((log.records, f.read()))
    assert logs[0] == logs[1]
    assert obs.NULL_EVENTS.emit("step") is None and not obs.NULL_EVENTS.records


def test_telemetry_bundle_and_coercion(tmp_path):
    tel = obs.as_telemetry(str(tmp_path / "tel"))
    assert isinstance(tel, obs.Telemetry) and tel.enabled
    assert tel.manifest_once(config={}, plan={}, world=1)
    assert not tel.manifest_once(config={}, plan={}, world=1)
    tel.registry.gauge("g").set(1.0)
    paths = tel.save()
    tel.close()
    assert sorted(paths) == ["events", "prom", "snapshot", "trace"]
    assert all(os.path.exists(p) for p in paths.values())
    mem = obs.Telemetry()
    mem.events.emit("note", message="in memory")
    with pytest.raises(ValueError, match="no directory"):
        mem.save()
    assert os.path.exists(mem.save(str(tmp_path / "mem"))["events"])
    assert obs.as_telemetry(None) is obs.NULL_TELEMETRY and not obs.NULL_TELEMETRY.enabled
    assert obs.as_telemetry(mem) is mem
    assert obs.NULL_TELEMETRY.save() is None
    for bad in (3, object()):
        with pytest.raises(TypeError) as e:
            obs.as_telemetry(bad)
        with pytest.raises(TypeError) as f:
            robs.as_telemetry(bad)
        assert str(e.value) == str(f.value)


def _trainer():
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu", seed=0)
    tc = TrainConfig(interval=2, bucket_bytes=1 << 14, max_buckets=32, log_every=1)
    return Trainer(model, optim.sgd(1e-2, momentum=0.9), tc)


def test_trainer_run_with_telemetry_records_and_changes_nothing(tmp_path):
    loader = make_loader(DataConfig(vocab_size=512, seq_len=16, global_batch=2),
                         device="cpu")
    states = []
    for telemetry in (None, str(tmp_path / "tel")):
        tr = _trainer()
        state = tr.run(tr.init_state(), iter([loader.make(s) for s in range(3)]),
                       steps=3, log=None, telemetry=telemetry)
        states.append(state["params"] + state["comp"])
    assert all(torch.equal(a, b) for a, b in zip(*states))
    assert tr.telemetry.enabled and tr.runtime is None
    tr.telemetry.close()
    with open(tmp_path / "tel" / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert [e["kind"] for e in events] == ["manifest", "step", "step", "step"]
    assert all(obs.validate_event(e) == [] == robs.validate_event(e) for e in events)
    assert events[0]["plan"]["digest"] == obs.plan_digest(tr.plan)
    assert events[0]["world"] == 1 and events[0]["config"]["interval"] == 2
    assert tr.telemetry.registry.snapshot()["train_steps_total"] == 3.0
