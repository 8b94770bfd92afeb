"""The public names the port carries for the reference's, each against the
reference's value on the same inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models as rmodels
from repro.core import compressors as rcompressors
from repro.core import error_feedback as ref_ef
from repro.core import filter as rfilter
from repro.core import schedule as rschedule
from repro.data import synthetic as rsynthetic
from repro.optim import schedules as rschedules

import repro_torch.configs as configs
import repro_torch.models as models
from repro_torch.core import build_plan, compressors, error_feedback, filter, schedule
from repro_torch.data import synth_batch, zipf_tokens
from repro_torch.optim import linear_warmup


def test_model_flops_equals_reference_at_full_width():
    cfg, rcfg = configs.get_config("gpt2-paper"), rconfigs.get_config("gpt2-paper")
    for kind in ("train", "decode"):
        assert models.model_flops(cfg, 8 * 1024, kind) == rmodels.model_flops(
            rcfg, 8 * 1024, kind)
    assert models.model_flops(cfg, 1024) == 6.0 * 190_532_352 * 1024


@pytest.mark.parametrize("model_axis", [1, 2, 16])
@pytest.mark.parametrize("reduced", [False, True])
def test_build_param_specs_equals_reference(model_axis, reduced):
    get = "get_reduced" if reduced else "get_config"
    cfg, rcfg = getattr(configs, get)("gpt2-paper"), getattr(rconfigs, get)("gpt2-paper")
    want = rmodels.build_param_specs(rcfg, rmodels.build_model(rcfg).init, model_axis,
                                     "model")
    flat = {".".join(str(k.key) for k in path): tuple(spec) for path, spec in
            jax.tree_util.tree_leaves_with_path(
                want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    got = models.build_param_specs(cfg, model_axis, "model")
    assert list(got) == list(flat)
    assert got == flat


def test_long_context_variant_and_input_shapes_equal_reference():
    cfg, rcfg = configs.get_config("gpt2-paper"), rconfigs.get_config("gpt2-paper")
    assert models.long_context_variant(cfg).sliding_window == \
        rmodels.long_context_variant(rcfg).sliding_window == 8192
    # the port's attention has the sliding window: the variant builds
    models.build_model(models.long_context_variant(cfg), device="meta")
    assert {k: tuple(vars(v).values()) for k, v in configs.INPUT_SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in rconfigs.INPUT_SHAPES.items()}
    assert models.InputShape is configs.InputShape
    assert "gpt2-paper" in configs.list_archs()
    assert set(configs.reference_archs()) <= set(rconfigs.list_archs())


@pytest.mark.parametrize("interval", [1, 3, 4])
def test_filter_names_equal_reference(interval):
    for b in range(7):
        for s in range(9):
            assert filter.is_selected(b, s, interval) == rfilter.is_selected(b, s, interval)
    assert filter.schedule_table(7, interval, 9) == rfilter.schedule_table(7, interval, 9)


def test_error_feedback_names_equal_reference():
    rng = np.random.default_rng(0)
    g, r, sent = (rng.standard_normal(1000).astype(np.float32) for _ in range(3))
    c = 0.3
    t = error_feedback.compensate([torch.from_numpy(g)], [torch.from_numpy(r)], c)[0]
    rt = ref_ef.compensate({"w": jnp.asarray(g)}, {"w": jnp.asarray(r)}, c)["w"]
    np.testing.assert_array_equal(t.numpy(), np.asarray(rt))
    new = error_feedback.residual_update([t], [torch.from_numpy(sent)])[0]
    rnew = ref_ef.residual_update({"w": rt}, {"w": jnp.asarray(sent)})["w"]
    np.testing.assert_array_equal(new.numpy(), np.asarray(rnew))


def test_available_compressors_are_the_reference_s_ported_ones():
    got = compressors.available()
    assert got == sorted(got) and set(got) <= set(rcompressors.available())
    assert {"covap", "none", "fp16", "fp8wire", "efsignsgd", "powersgd", "topk",
            "dgc", "randomk", "oktopk"} == set(got)


def test_cycle_bytes_per_worker_equals_reference():
    from repro.core import build_plan as rbuild_plan
    from repro.core import get_compressor as rget

    rplan = rbuild_plan({"w": jax.ShapeDtypeStruct((5000,), np.float32)},
                        bucket_bytes=4096, max_buckets=8, interval=4)
    plan = build_plan([("w", torch.empty(5000, device="meta"))], bucket_bytes=4096,
                      max_buckets=8, interval=4)
    want = rschedule.cycle_bytes_per_worker(
        rschedule.plan_all_phases(rget("covap", interval=4), rplan, world=8))
    got = schedule.cycle_bytes_per_worker(
        schedule.plan_all_phases(compressors.get_compressor("covap", interval=4), plan,
                                 world=8))
    assert got == want > 0


def test_linear_warmup_equals_reference():
    fn, rfn = linear_warmup(3e-4, 7), rschedules.linear_warmup(3e-4, 7)
    for step in range(12):
        assert fn(step) == np.float32(rfn(step)), step


def test_zipf_tokens_equals_reference_and_synth_batch_has_its_shapes():
    a = zipf_tokens(np.random.default_rng(3), 4096, 512)
    b = rsynthetic.zipf_tokens(np.random.default_rng(3), 4096, 512)
    np.testing.assert_array_equal(a, b)
    from repro.data.pipeline import synth_batch as rsynth

    cfg = configs.get_reduced("gpt2-paper")
    for kind in ("train", "decode"):
        got = synth_batch(1, cfg, kind, 3, 16, device="cpu")
        want = rsynth(jax.random.PRNGKey(1), rconfigs.get_reduced("gpt2-paper"), kind, 3, 16)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape
            assert 0 <= int(got[k].min()) and int(got[k].max()) < cfg.vocab_size
        assert torch.equal(got["tokens"], synth_batch(1, cfg, kind, 3, 16,
                                                      device="cpu")["tokens"])
