"""The port's ``lowrank.matmul`` and ``threshold_filter`` against the Pallas
kernels (interpret mode) and the oracles of ``repro.kernels.ref``, and
``repro_torch.kernels.ops`` against ``repro.kernels.ops``.  On CPU tensors
each wrapper runs its plain PyTorch version; the CUDA kernels themselves
run only on the GPU (``test_torch_cuda.py``).

Tolerances: matmul as ``tests/test_kernels.py`` holds the Pallas kernel
(2e-4 in float32, 2e-2 from bfloat16 inputs: another order of summation);
the threshold filter and ``sample_threshold`` bit for bit."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rkref

from repro_torch.kernels import ops
from repro_torch.kernels.lowrank import matmul
from repro_torch.kernels.ref import matmul_ref, sample_threshold, threshold_filter_ref
from repro_torch.kernels.topk_threshold import threshold_filter

lowrank_mod = importlib.import_module("repro_torch.kernels.lowrank")
thresh_mod = importlib.import_module("repro_torch.kernels.topk_threshold")

torch.set_num_threads(2)


def test_ops_has_every_name_of_the_reference():
    assert set(rops.__all__) <= set(ops.__all__)
    assert set(ops.__all__) == set(rops.__all__) | {"pack_ef_cast"}
    for name in ops.__all__:
        assert callable(getattr(ops, name))


# ---- lowrank.matmul ----------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (128, 128, 128), (300, 257, 2),
                                   (64, 1000, 4)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_matmul_ref_matches_pallas_kernel(m, k, n, dtype):
    a = jax.random.normal(jax.random.PRNGKey(0), (m, k)).astype(dtype)
    b = jax.random.normal(jax.random.PRNGKey(1), (k, n)).astype(dtype)
    want = rops.matmul(a, b, bm=128, bn=128, bk=128, interpret=True)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    ta = torch.from_numpy(np.array(a, np.float32)).to(tdt)
    tb = torch.from_numpy(np.array(b, np.float32)).to(tdt)
    got = matmul_ref(ta, tb)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    tol = 2e-4 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(rkref.matmul_ref(a, b)),
                               rtol=tol, atol=tol)
    if dtype == jnp.float32:
        np.testing.assert_array_equal(matmul(ta, tb).numpy(), got.numpy())


@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("trans_b", [False, True])
def test_matmul_reads_transposed_operands_through_strides(trans_a, trans_b):
    """``(B, m, k) @ (B, k, n)`` with either operand given transposed (and
    non-contiguous views): the float64 product of the same matrices, at the
    float32 bound."""
    rng = np.random.default_rng(7)
    B, m, k, n = 3, 37, 300, 5
    A = rng.standard_normal((B, m, k)).astype(np.float32)
    Bm = rng.standard_normal((B, k, n)).astype(np.float32)
    a = torch.from_numpy(np.ascontiguousarray(A.transpose(0, 2, 1)) if trans_a else A)
    b = torch.from_numpy(np.ascontiguousarray(Bm.transpose(0, 2, 1)) if trans_b else Bm)
    got = matmul(a, b, trans_a=trans_a, trans_b=trans_b)
    want = A.astype(np.float64) @ Bm.astype(np.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # a view whose last axis is not contiguous reads the same matrices
    got_t = matmul(a.transpose(-1, -2), b, trans_a=not trans_a, trans_b=trans_b)
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())


@pytest.mark.parametrize(
    "a,b,kw,exc",
    [
        (torch.zeros(2, 3, dtype=torch.float64), torch.zeros(3, 2), {}, TypeError),
        (torch.zeros(2, 3), torch.zeros(3, 2, dtype=torch.bfloat16), {}, TypeError),
        (torch.zeros(2, 3), torch.zeros(4, 2), {}, ValueError),
        (torch.zeros(2, 2, 3), torch.zeros(3, 3, 2), {}, ValueError),
        (torch.zeros(2, 2, 3), torch.zeros(3, 2), {}, ValueError),
        (torch.zeros(3), torch.zeros(3, 2), {}, ValueError),
        (torch.zeros(2, 3), torch.zeros(3, 2), {"trans_a": True}, ValueError),
    ],
    ids=["f64", "bf16", "inner", "batch", "rank-mismatch", "1-d", "trans-shape"],
)
def test_matmul_rejects_what_the_kernel_does_not_take(a, b, kw, exc):
    with pytest.raises(exc):
        matmul(a, b, **kw)


# ---- threshold_filter and sample_threshold ----------------------------------

def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("n", [1, 127, 4096, 33333, 100_000])
@pytest.mark.parametrize("ratio", [0.05, 0.01, 0.001])
def test_threshold_filter_matches_pallas_kernel_above_zero(n, ratio):
    """At t > 0 the port's plain version equals the Pallas kernel (interpret
    mode) and the eager oracle bit for bit, in y and in the counts; its
    ``sample_threshold`` equals the reference's bit for bit."""
    x = _x(n, n)
    rt = rops.sample_threshold(jnp.asarray(x), ratio)
    t = sample_threshold(torch.from_numpy(x), ratio)
    assert t.dim() == 0 and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.asarray(rt))
    assert float(t) > 0
    py, pc = rops.threshold_filter(jnp.asarray(x), rt, block=4096, interpret=True)
    ry, rc = rkref.threshold_filter_ref(jnp.asarray(x), rt, block=4096)
    y, c = threshold_filter(torch.from_numpy(x), t, block=4096)
    for want_y, want_c in ((py, pc), (ry, rc)):
        np.testing.assert_array_equal(y.numpy().view(np.int32),
                                      np.asarray(want_y).view(np.int32))
        np.testing.assert_array_equal(c.numpy(), np.asarray(want_c))
    assert c.dtype == torch.int32


@pytest.mark.parametrize("n,block", [(5000, 4096), (70_001, 32768), (4096, 4096)])
def test_threshold_filter_counts_only_real_elements_at_zero(n, block):
    """At t = 0 on a ragged input the Pallas kernel counts its zero padding
    as survivors (a reference quirk); the port counts real elements only,
    as ``threshold_filter_ref`` does, and y agrees with both."""
    x = _x(n, 3)
    x[:4] = [0.0, -0.0, np.nan, np.inf]
    py, pc = rops.threshold_filter(jnp.asarray(x), jnp.float32(0.0), block=block,
                                   interpret=True)
    ry, rc = rkref.threshold_filter_ref(jnp.asarray(x), jnp.float32(0.0), block=block)
    y, c = threshold_filter(torch.from_numpy(x), torch.tensor(0.0), block=block)
    np.testing.assert_array_equal(y.numpy().view(np.int32), np.asarray(ry).view(np.int32))
    np.testing.assert_array_equal(y.numpy().view(np.int32), np.asarray(py).view(np.int32))
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    # every real element survives but the NaN; -0.0 survives as -0.0
    want = [min(block, n - i) for i in range(0, n, block)]
    want[0] -= 1
    assert c.tolist() == want
    assert np.signbit(y[1].item()) and y[2] == 0 and y[3] == np.inf
    if n % block:
        assert int(np.asarray(pc)[-1]) == block      # the quirk, on record


def test_threshold_filter_special_values():
    """NaN gives +0.0 and is not counted; +-inf survive any finite threshold;
    a Python-number threshold equals a tensor one."""
    x = np.array([np.nan, np.inf, -np.inf, 0.5, -0.5, 2.0, -0.0, 1e-45], np.float32)
    y, c = threshold_filter(torch.from_numpy(x), 0.5, block=4)
    y2, c2 = threshold_filter(torch.from_numpy(x), torch.tensor(0.5), block=4)
    assert torch.equal(y.view(torch.int32), y2.view(torch.int32)) and torch.equal(c, c2)
    assert y.tolist()[1:6] == [np.inf, -np.inf, 0.5, -0.5, 2.0]
    assert y[0].item() == 0 and not np.signbit(y[0].item())
    assert c.tolist() == [3, 2]


@pytest.mark.parametrize(
    "x,t,kw,exc",
    [
        (torch.zeros(8, dtype=torch.float64), 0.5, {}, TypeError),
        (torch.zeros(2, 4), 0.5, {}, ValueError),
        (torch.zeros(16)[::2], 0.5, {}, ValueError),
        (torch.zeros(8), 0.5, {"block": 0}, ValueError),
    ],
    ids=["f64", "not-flat", "strided", "block-0"],
)
def test_threshold_filter_rejects_what_the_kernel_does_not_take(x, t, kw, exc):
    with pytest.raises(exc):
        threshold_filter(x, t, **kw)


def test_counters_stay_zero_on_cpu_and_nothing_is_built():
    before = (matmul.launches, threshold_filter.launches)
    a = torch.randn(2, 5, 7)
    matmul(a, torch.randn(2, 7, 3))
    matmul(a, torch.randn(2, 5, 3), trans_a=True)
    threshold_filter(torch.randn(100), 0.1)
    assert (matmul.launches, threshold_filter.launches) == before
    assert lowrank_mod._launchers.cache_info().currsize == 0
    assert thresh_mod._launcher.cache_info().currsize == 0
    for src, marks in (
        ("lowrank_matmul.cu", ('extern "C" int lowrank_matmul_launch',
                               'extern "C" long long lowrank_matmul_workspace',
                               "src/repro/kernels/lowrank.py::matmul")),
        ("threshold_filter.cu", ('extern "C" int threshold_filter_launch',
                                 "src/repro/kernels/topk_threshold.py::threshold_filter")),
    ):
        text = (lowrank_mod._build.CSRC / src).read_text()
        assert all(m in text for m in marks), src
