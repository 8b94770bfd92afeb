"""The port's ``ef_update`` against the Pallas kernel (interpret mode) on
the ``tests/test_kernels.py`` grid plus ragged sizes, and the wrapper's
rules.  On CPU tensors the wrapper runs its plain PyTorch version; the
CUDA kernel itself runs only on the GPU (``test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from repro.kernels.ef_covap import ef_update as pallas_ef_update

from repro_torch.kernels import ef_covap
from repro_torch.kernels.ef_covap import ef_update, ef_update_cuda
from repro_torch.kernels.ref import ef_update_ref

torch.set_num_threads(2)

SIZES = [1, 127, 4096, 33333, 100_000, 4099, 65_537]
COEFF = 0.7


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _assert_ef_close(got, want, r, c):
    """rtol 1e-6, atol 1e-6 * max|c r|: room for the one rounding by which
    an FMA and ``g + c*r`` may differ; zeros must be exact."""
    atol = 1e-6 * float(np.max(np.abs(c * r))) if r.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("selected", [True, False])
def test_ef_update_matches_pallas_kernel(n, selected):
    g, r = _inputs(n)
    ps, pr = pallas_ef_update(g, r, COEFF, selected=selected, block=4096,
                              interpret=True)
    ts, tr = ef_update(torch.from_numpy(g), torch.from_numpy(r), COEFF,
                       selected=selected)
    _assert_ef_close(ts.numpy(), np.asarray(ps), r, COEFF)
    _assert_ef_close(tr.numpy(), np.asarray(pr), r, COEFF)
    zero = tr if selected else ts
    assert torch.count_nonzero(zero) == 0


@pytest.mark.parametrize("selected", [True, False])
def test_ef_update_cpu_is_the_plain_two_op_form(selected):
    g, r = _inputs(1000, seed=3)
    gt, rt = torch.from_numpy(g), torch.from_numpy(r)
    t = gt + np.float32(0.3) * rt
    s, q = ef_update(gt, rt, 0.3, selected=selected)
    assert torch.equal(s if selected else q, t)


def test_cuda_only_path_raises_on_cpu():
    g = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        ef_update_cuda(g, g.clone(), 0.5, selected=True)


@pytest.mark.parametrize(
    "g,r,exc",
    [
        (torch.zeros(8, dtype=torch.bfloat16), torch.zeros(8, dtype=torch.bfloat16), TypeError),
        (torch.zeros(8), torch.zeros(8, dtype=torch.float64), TypeError),
        (torch.zeros(16)[::2], torch.zeros(8), ValueError),
        (torch.zeros(8), torch.zeros(9), ValueError),
        (torch.zeros(2, 4), torch.zeros(2, 4), ValueError),
    ],
    ids=["bf16", "f64-residual", "non-contiguous", "shape-mismatch", "not-flat"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(g, r, exc):
    with pytest.raises(exc):
        ef_update(g, r, 0.5, selected=True)
    with pytest.raises(exc):
        ef_update_cuda(g, r, 0.5, selected=True)


def test_launch_counter_stays_zero_on_cpu():
    before = ef_update.launches
    g, r = _inputs(100)
    for sel in (True, False):
        ef_update(torch.from_numpy(g), torch.from_numpy(r), 0.5, selected=sel)
    assert ef_update.launches == before


def test_kernel_source_is_in_the_package_and_nothing_is_built_on_cpu():
    text = (ef_covap._build.CSRC / "ef_covap.cu").read_text()
    assert 'extern "C" int ef_update_launch' in text
    assert "src/repro/kernels/ef_covap.py::ef_update" in text
    g, r = _inputs(64)
    ef_update(torch.from_numpy(g), torch.from_numpy(r), 0.5, selected=False)
    assert ef_covap._launcher.cache_info().currsize == 0
