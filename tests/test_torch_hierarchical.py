"""Hierarchical pods of the port against the reference's.

* ``plan_pod_schedule``: calls and bytes equal the reference's over numel x
  intra-pod world x pods x sync, and at full width (2 pods x 8);
* the merged per-phase schedules and their per-link bytes equal the
  reference trainer's on a (pod=2, data=4) plan, and the perf model prices
  each call on its own link as the reference does;
* the W-aligned shard decomposition of ``pod_reconcile`` round-trips;
* ``exposed_comm_scale``: 0.5 flat, in (0.5, 1] hierarchical, equal to the
  reference's on the same explicit spec;
* four gloo ranks (2 pods x 2) after 5 SGD steps of COVAP ``I = 2``,
  ``pod_interval = 4`` against the reference's (pod=2, data=2) CPU mesh on
  the same exported parameters and batches: every rank's params and
  momenta against its pod's block, the intra-index-0 ranks' residuals
  against the block's (the reference keeps one residual per pod block).
  SGD, as in ``test_torch_multiworker.py``: AdamW's ``m / sqrt(v)`` turns
  the last-bit gradient differences of two reduction orders into whole
  ``lr``-sized steps on elements whose gradient is about 0;
* hierarchical sharded (and sharded + arena) == hierarchical allreduce bit
  for bit through ``Trainer.run``, with SGD and with AdamW (moments
  included); drift between the pods in (0, 1);
* checkpoint (per rank: the pods' params differ), resume, the guards'
  skip-step and a re-plan on a hierarchical sharded trainer on 2 pods x 2;
* the port's ``hier_gate`` on 2 pods x 4 gloo ranks;
* a pod group at ``pod_interval = 1`` is refused.
"""
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from _torch_dist_worker import hier_resume_worker, hier_worker

from repro.core import arena as rar
from repro.core import build_plan as rbuild_plan
from repro.train.trainer import plan_pod_schedule as rplan_pod_schedule

from repro_torch.configs import get_config, get_reduced
from repro_torch.core import arena as ar
from repro_torch.core import build_plan, get_compressor
from repro_torch.core.ccr import HardwareSpec
from repro_torch.core.perfmodel import schedule_comm_times, simulate_schedule
from repro_torch.models import param_shapes
from repro_torch.runtime import exposed_comm_scale
from repro_torch.train import hierarchical_schedules, plan_pod_schedule

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ROOT = os.path.dirname(SRC)

# the reference's trainer test and its (pod, data) mesh, cut to 2 x 2
N_PODS, INTRA = 2, 2
WORLD = N_PODS * INTRA
STEPS = 5
LR = 1e-2
TC = dict(compressor="covap", interval=2, pod_interval=4, bucket_bytes=1 << 13,
          max_buckets=16, log_every=1)
DATA = dict(vocab_size=128, seq_len=24, global_batch=8, corpus_tokens=1 << 12)
PORT_RUNS = {"allreduce": ("sgd", TC), "sharded": ("sgd", dict(TC, sync="sharded")),
             "sharded-arena": ("sgd", dict(TC, sync="sharded", arena=True)),
             "adam-allreduce": ("adam", TC),
             "adam-sharded": ("adam", dict(TC, sync="sharded"))}
SHARDED_RUNS = {"sharded": "allreduce", "sharded-arena": "allreduce",
                "adam-sharded": "adam-allreduce"}
# the reference gate's plan (hier_gate.build_trainer)
GATE_TC = dict(compressor="covap", interval=4, bucket_bytes=1 << 14, max_buckets=32)
# an explicit two-link spec, passed to both packages (ici 8x the dcn)
ICI, DCN = 50e9, 6.25e9


def _plan_pair(numel):
    rplan = rbuild_plan({"w": jax.ShapeDtypeStruct((numel,), np.float32)},
                        bucket_bytes=1 << 30, max_buckets=1, interval=1)
    plan = build_plan([("w", torch.empty(numel, device="meta"))],
                      bucket_bytes=1 << 30, max_buckets=1, interval=1)
    return rplan, plan


def _calls(sched):
    return [(c.target, c.op, c.wire_dtype, c.payload_bytes, c.index_bytes, c.link,
             c.world) for c in sched.calls]


@pytest.mark.parametrize("sync", ["allreduce", "sharded"])
@pytest.mark.parametrize("n_pods", [2, 3])
@pytest.mark.parametrize("intra", [1, 2, 8])
@pytest.mark.parametrize("numel", [1, 37, 4096])
def test_plan_pod_schedule_equals_reference(numel, intra, n_pods, sync):
    rplan, plan = _plan_pair(numel)
    for pod_interval in (1, 3):
        for phase in range(pod_interval):
            kw = dict(pod_phase=phase, pod_interval=pod_interval, sync=sync,
                      intra_world=intra, n_pods=n_pods)
            want, got = rplan_pod_schedule(rplan, **kw), plan_pod_schedule(plan, **kw)
            assert _calls(got) == _calls(want)
            assert got.selected == want.selected and got.dense_bytes == want.dense_bytes
            assert got.exposed_bytes_by_link() == want.exposed_bytes_by_link()
            assert got.exposed_wire_bytes_by_link(1) == want.exposed_wire_bytes_by_link(1)
            assert got.links == want.links


def _reference_trainer(arch_cfg, n_pods, data, sync="sharded", pod_interval=2,
                       **tc):
    from repro.models import build_model
    from repro.optim import adamw
    from repro.train.trainer import TrainConfig, Trainer

    class _FakeMesh:                       # schedules() reads only the shape
        shape = {"pod": n_pods, "data": data}

    return Trainer(build_model(arch_cfg), adamw(1e-3),
                   TrainConfig(sync=sync, pod_interval=pod_interval, **tc),
                   mesh=_FakeMesh(), dp_axes=("pod", "data"))


def _port_schedules(cfg, n_pods, data, sync="sharded", pod_interval=2,
                    compressor="covap", interval=4, bucket_bytes=1 << 14,
                    max_buckets=32):
    leaves = [(k, torch.empty(s, device="meta")) for k, s in param_shapes(cfg).items()]
    plan = build_plan(leaves, bucket_bytes=bucket_bytes, max_buckets=max_buckets,
                      interval=interval)
    opts = {"interval": interval} | ({"sync": sync} if sync != "allreduce" else {})
    return hierarchical_schedules(get_compressor(compressor, **opts), plan,
                                  pod_interval=pod_interval, sync=sync,
                                  intra_world=data, n_pods=n_pods)


def _assert_schedules_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.phase, g.num_phases, g.selected, g.ready_ranks) == (
            w.phase, w.num_phases, w.selected, w.ready_ranks)
        assert _calls(g) == _calls(w)
        assert [(c.target, c.payload_bytes) for c in g.deferred_calls] == [
            (c.target, c.payload_bytes) for c in w.deferred_calls]
        assert g.links == tuple(w.links)
        assert g.exposed_bytes_by_link() == w.exposed_bytes_by_link()
        assert g.deferred_bytes_by_link() == w.deferred_bytes_by_link()
        assert g.exposed_wire_bytes_by_link() == pytest.approx(
            w.exposed_wire_bytes_by_link(), rel=1e-15)
        assert g.summary() == w.summary()


@pytest.mark.parametrize("sync", ["allreduce", "sharded"])
def test_merged_schedules_equal_reference(sync):
    from repro.configs import get_reduced as rget_reduced

    rcfg = rget_reduced("gpt2-paper").with_(vocab_size=256)
    want = _reference_trainer(rcfg, 2, 4, sync=sync, **GATE_TC).schedules()
    got = _port_schedules(get_reduced("gpt2-paper").with_(vocab_size=256), 2, 4,
                          sync=sync)
    _assert_schedules_equal(got, want)
    assert len(got) == 4 and all(s.links == ("ici", "dcn") for s in got)


@pytest.mark.parametrize("sync", ["allreduce", "sharded"])
def test_full_width_pod_plan_equals_reference(sync):
    """Full-width gpt2-paper at 2 pods x 8 workers, the trainer's default
    buckets: each phase's calls and bytes per link."""
    from repro.configs import get_config as rget_config

    tc = dict(compressor="covap", interval=4, bucket_bytes=25 * 1024 * 1024,
              max_buckets=128)
    want = _reference_trainer(rget_config("gpt2-paper"), 2, 8, sync=sync,
                              **tc).schedules()
    got = _port_schedules(get_config("gpt2-paper"), 2, 8, sync=sync, **tc)
    _assert_schedules_equal(got, want)


def test_perfmodel_prices_each_link_like_the_reference():
    from repro.configs import get_reduced as rget_reduced
    from repro.core import perfmodel as rpm

    want = _reference_trainer(rget_reduced("gpt2-paper").with_(vocab_size=256), 2, 4,
                              **GATE_TC).schedules()[0]
    got = _port_schedules(get_reduced("gpt2-paper").with_(vocab_size=256), 2, 4)[0]
    bw = {"ici": 1e9, "dcn": 1e8}
    assert schedule_comm_times(got, world=4, link_bw=bw) == rpm.schedule_comm_times(
        want, world=4, link_bw=bw)
    assert simulate_schedule(1e-3, 1e-3, got, world=4, link_bw=bw) == \
        rpm.simulate_schedule(1e-3, 1e-3, want, world=4, link_bw=bw)
    fast = schedule_comm_times(got, world=4, link_bw={"ici": 1e9, "dcn": 1e18})
    flat = schedule_comm_times(got, world=4, link_bw=1e9)
    dcn_share = sum(c.wire_bytes(4) for c in got.calls if c.link == "dcn") / 1e9
    assert sum(flat) - sum(fast) == pytest.approx(dcn_share, rel=1e-6)
    with pytest.raises(KeyError, match="dcn"):
        schedule_comm_times(got, world=4, link_bw={"ici": 1e9})


@pytest.mark.parametrize("n_pods", [2, 4])
@pytest.mark.parametrize("intra", [2, 4, 8])
@pytest.mark.parametrize("numel", [1, 999, 3000])
def test_aligned_shard_exchange_roundtrip_unchanged(numel, intra, n_pods):
    """``pod_reconcile``'s decomposition: the W shards of the aligned slot
    cover it once, unpack to the leaf bit for bit, and the zero tail stays
    zero through a cross-pod mean."""
    rng = np.random.RandomState(numel)
    x = torch.from_numpy(rng.randn(numel).astype(np.float32))
    _, plan = _plan_pair(numel)
    layout = ar.build_layout(plan, (0,), align=intra)
    view = layout.bucket_view(ar.pack_leaves(layout, [x]), 0)
    assert view.numel() == ar.aligned_numel(numel, intra) == rar.aligned_numel(numel, intra)
    S = view.numel() // intra
    out = torch.cat([view[w * S:(w + 1) * S] for w in range(intra)])
    assert torch.equal(out, view)
    (piece,) = layout.unpack_bucket(0, out)
    assert torch.equal(piece, x)
    pods = torch.stack([
        layout.bucket_view(ar.pack_leaves(
            layout, [torch.from_numpy(rng.randn(numel).astype(np.float32))]), 0)
        for _ in range(n_pods)])
    assert torch.count_nonzero(pods.mean(0)[numel:]) == 0


def _stub(schedules, sync, world):
    return types.SimpleNamespace(tc=types.SimpleNamespace(sync=sync), dp_world=world,
                                 schedules=lambda: schedules)


def test_exposed_comm_scale_reads_the_slowest_link():
    """Flat sharded: 0.5; hierarchical sharded: above it, at most 1, and the
    reference's value on the same spec and plan."""
    from repro.configs import get_reduced as rget_reduced
    from repro.core.ccr import HardwareSpec as RSpec
    from repro.runtime import exposed_comm_scale as rscale

    spec = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=ICI, mfu=0.4)
    hw, rhw = HardwareSpec(**spec, dcn_bw=DCN), RSpec(**spec, dcn_bw=DCN)
    cfg = get_reduced("gpt2-paper").with_(vocab_size=256)
    leaves = [(k, torch.empty(s, device="meta")) for k, s in param_shapes(cfg).items()]
    plan = build_plan(leaves, bucket_bytes=1 << 14, max_buckets=32, interval=4)
    comp = get_compressor("covap", interval=4, sync="sharded")
    flat = [comp.plan_phase(plan, p, world=8) for p in range(4)]
    assert exposed_comm_scale(_stub(flat, "sharded", 8), hw) == pytest.approx(0.5, abs=1e-12)
    hier = _port_schedules(cfg, 2, 4)
    got = exposed_comm_scale(_stub(hier, "sharded", 4), hw)
    want = rscale(_reference_trainer(rget_reduced("gpt2-paper").with_(vocab_size=256),
                                     2, 4, **GATE_TC), rhw)
    assert 0.5 < got <= 1.0
    assert got == pytest.approx(want, rel=1e-12)
    assert exposed_comm_scale(_stub(hier, "allreduce", 4), hw) == 1.0


def test_hardware_spec_dcn_defaults_to_the_ici_link():
    assert HardwareSpec(peak_flops=1.0, hbm_bw=1.0, ici_bw=3.0, mfu=0.5).dcn_bw == 3.0
    v100 = HardwareSpec.cloud_v100_30gbps()
    assert v100.dcn_bw == v100.ici_bw == 30e9 / 8


def test_a_pod_group_without_a_pod_interval_is_refused():
    """At ``pod_interval = 1`` the gradients would sync over the intra-pod
    group alone and the pods would train apart: the trainer refuses."""
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.train import TrainConfig, Trainer

    model = build_model(get_reduced("gpt2-paper"), device="meta")
    with pytest.raises(ValueError, match="pod_interval > 1"):
        Trainer(model, sgd(0.1), TrainConfig(pod_interval=1), pod_group=object())


REFERENCE = """
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_reduced
from repro.data import DataConfig, make_loader
from repro.models import build_model
from repro.optim import sgd
from repro.train.trainer import TrainConfig, Trainer

def flat(tree, prefix=""):
    out = {{}}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out

mesh = Mesh(np.array(jax.devices()[:{world}]).reshape({n_pods}, -1), ("pod", "data"))
cfg = get_reduced("gpt2-paper").with_(vocab_size={vocab})
tc = dict({tc})
tr = Trainer(build_model(cfg), sgd({lr}, momentum=0.9), TrainConfig(**tc), mesh=mesh,
             dp_axes=("pod", "data"))
assert tr.hierarchical
state = tr.init_state(jax.random.PRNGKey(0))
np.savez({init!r}, **{{k: v[0] for k, v in flat(state["params"]).items()}})
state = tr.run(state, iter(make_loader(DataConfig(**{data}))), steps={steps}, log=None)
out = {{"losses": np.array([h["loss"] for h in tr.history])}}
parts = {{"params": state["params"], "resid": state["comp"], "mu": state["opt"]["mu"]}}
for part, tree in parts.items():
    for k, v in flat(tree).items():
        for p in range({n_pods}):
            out["pod%d/%s:%s" % (p, part, k)] = v[p]
np.savez({out!r}, **out)
"""


def _spawn(worker, args, nprocs):
    ctx = mp.start_processes(worker, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    for _ in range(600):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        raise AssertionError("gloo workers did not finish within 600 s")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (reference, [rank 0..3]): the reference's pod-mesh run in one
    subprocess, the port's three hierarchical runs on four gloo ranks."""
    tmp = tmp_path_factory.mktemp("hier")
    init, out = str(tmp / "init.npz"), str(tmp / "ref.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    code = REFERENCE.format(world=WORLD, n_pods=N_PODS, vocab=DATA["vocab_size"],
                            tc={k: v for k, v in TC.items()}, lr=LR, init=init,
                            data=DATA, steps=STEPS, out=out)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    _spawn(hier_worker, (WORLD, str(tmp / "rendezvous"), init, str(tmp / "port"),
                         N_PODS, PORT_RUNS, DATA, LR, STEPS), WORLD)
    return dict(np.load(out)), [dict(np.load(tmp / f"port{r}.npz")) for r in range(WORLD)]


def _part(tree, prefix):
    return {k[len(prefix):]: v for k, v in tree.items() if k.startswith(prefix)}


def test_hierarchical_run_matches_the_reference_pod_blocks(runs):
    """Each rank against its pod's block: allclose at the SGD bound of the
    other port-vs-reference runs (gloo's reduction order is not XLA's)."""
    ref, ranks = runs
    for rank, got in enumerate(ranks):
        pod = rank // INTRA
        assert int(got["pod"]) == pod
        np.testing.assert_allclose(got["allreduce/losses"], ref["losses"], rtol=1e-5)
        parts = ("params", "mu") + (("resid",) if rank % INTRA == 0 else ())
        for part in parts:
            want = _part(ref, f"pod{pod}/{part}:")
            assert want
            for key, v in want.items():
                np.testing.assert_allclose(got[f"allreduce/{part}:{key}"], v,
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"rank {rank} {part}:{key}")


@pytest.mark.parametrize("run", sorted(SHARDED_RUNS))
def test_hierarchical_sharded_equals_allreduce_bitwise(runs, run):
    _, ranks = runs
    base = SHARDED_RUNS[run]
    for got in ranks:
        keys = [k for k in got if k.startswith(f"{base}/")]
        assert len(keys) > 4
        for key in keys:
            np.testing.assert_array_equal(got[run + key[len(base):]], got[key],
                                          err_msg=f"{run} {key}")


def test_pods_drift_between_reconciliations_and_agree_inside(runs):
    """As the reference requires: the pods' params differ, by less than 1,
    and the ranks of one pod hold the same params."""
    _, ranks = runs
    params = [_part(g, "allreduce/params:") for g in ranks]
    drift = max(float(np.max(np.abs(params[0][k] - params[INTRA][k]))) for k in params[0])
    assert 0.0 < drift < 1.0, drift
    for k in params[0]:
        np.testing.assert_array_equal(params[0][k], params[1][k])
        np.testing.assert_array_equal(params[INTRA][k], params[INTRA + 1][k])


def test_checkpoint_guards_and_replan_on_a_hierarchical_trainer(tmp_path):
    """Resume from a per-rank checkpoint == the uninterrupted run bit for bit
    on every rank; a guarded run skips the ``grad_nan`` step on every rank
    alike and commits every step; a re-plan keeps the pods; the ranks of a
    pod agree in params throughout."""
    tc = dict(TC, sync="sharded")
    _spawn(hier_resume_worker, (WORLD, str(tmp_path / "rendezvous"), str(tmp_path / "ckpt"),
                                str(tmp_path / "port"), N_PODS, tc, DATA, LR, STEPS, 2),
           WORLD)
    ranks = [dict(np.load(tmp_path / f"port{r}.npz")) for r in range(WORLD)]
    for got in ranks:
        whole = _part(got, "whole/")
        assert whole
        for key, v in whole.items():
            np.testing.assert_array_equal(got[f"resumed/{key}"], v, err_msg=key)
        assert int(got["guarded/step"]) == STEPS
        assert (int(got["guarded/trips"]), int(got["guarded/actions"])) == (1, 1)
        for run in ("guarded", "replan"):
            assert all(np.isfinite(v).all() for v in _part(got, f"{run}/").values())
    for run in ("whole", "guarded", "replan"):
        for pod in range(N_PODS):
            a, b = (_part(ranks[pod * INTRA + i], f"{run}/params:") for i in range(2))
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{run} {key}")


def test_hier_gate_on_two_pods_of_four_gloo_ranks():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.hier_gate",
                        "--device", "cpu"], capture_output=True, text=True,
                       timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    line = next(l for l in r.stdout.splitlines() if l.startswith("HIER"))
    kv = dict(p.split("=") for p in line.split()[1:])
    assert kv["match"] == "1" and kv["steps"] == "4"
    assert kv["ici_counted"] == kv["ici_schedule"] and kv["dcn_counted"] == kv["dcn_schedule"]
    assert int(kv["dcn_schedule"]) > 0
    # the metric averages ride both links outside the plan, counted apart
    assert int(kv["ici_unplanned"]) > 0 and int(kv["dcn_unplanned"]) > 0
    assert kv["hier_exposed_dcn_ratio"] == "0.4000"
