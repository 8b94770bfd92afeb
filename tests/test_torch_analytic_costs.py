"""The port's analytic per-step costs (``repro_torch.launch.analytic_costs``)
against ``repro.launch.analytic_costs``: the same closed forms, so the same
floats (rtol 1e-12) for every arch of ``list_archs()`` and every named
input shape, and the H100 spec the dry run prices them on."""
import functools

import pytest

import repro.configs as rconfigs
from repro.launch import analytic_costs as r_costs

import repro_torch.configs as tconfigs
from repro_torch.core.ccr import HardwareSpec
from repro_torch.launch import analytic_costs

ARCHS = tconfigs.reference_archs()
SHAPES = list(tconfigs.INPUT_SHAPES)
SHARDS = [(1, 1), (16, 16), (1, 8)]


@pytest.fixture(scope="module", autouse=True)
def _memoised_reference_count():
    """The reference's ``count_params`` traces the model's init with
    ``jax.eval_shape`` on every call; the closed forms call it once a
    call, so it is memoised per config for this module (same values)."""
    saved = r_costs.count_params
    r_costs.count_params = functools.lru_cache(maxsize=None)(saved)
    try:
        yield
    finally:
        r_costs.count_params = saved


def test_the_port_has_the_reference_archs_and_shapes():
    assert ARCHS == rconfigs.list_archs()
    assert SHAPES == list(rconfigs.INPUT_SHAPES)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_step_flops_equal_reference(arch, shape):
    got = analytic_costs.step_flops(tconfigs.get_config(arch), tconfigs.INPUT_SHAPES[shape])
    want = r_costs.step_flops(rconfigs.get_config(arch), rconfigs.INPUT_SHAPES[shape])
    assert got == pytest.approx(want, rel=1e-12, abs=0)
    assert got > 0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_step_hbm_bytes_equal_reference(arch, shape):
    for model_shard, data_shard in SHARDS:
        got = analytic_costs.step_hbm_bytes(
            tconfigs.get_config(arch), tconfigs.INPUT_SHAPES[shape],
            model_shard=model_shard, data_shard=data_shard)
        want = r_costs.step_hbm_bytes(
            rconfigs.get_config(arch), rconfigs.INPUT_SHAPES[shape],
            model_shard=model_shard, data_shard=data_shard)
        assert got == pytest.approx(want, rel=1e-12, abs=0), (model_shard, data_shard)


@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_bytes_equal_reference(arch, kv):
    shape = "decode_32k"
    got = analytic_costs._cache_bytes(tconfigs.get_config(arch).with_(kv_cache_dtype=kv),
                                      tconfigs.INPUT_SHAPES[shape])
    want = r_costs._cache_bytes(rconfigs.get_config(arch).with_(kv_cache_dtype=kv),
                                rconfigs.INPUT_SHAPES[shape])
    assert got == pytest.approx(want, rel=1e-12, abs=0)


def test_h100_spec_is_the_data_sheet_and_leaves_the_defaults_alone():
    hw = HardwareSpec.h100_sxm()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.dcn_bw, hw.mfu) == (
        989.4e12, 3.35e12, 450e9, 50e9, 0.4)
    v100 = HardwareSpec.cloud_v100_30gbps()
    assert (v100.peak_flops, v100.hbm_bw, v100.ici_bw, v100.mfu, v100.dcn_bw) == (
        125e12, 900e9, 30e9 / 8, 0.35, 30e9 / 8)
