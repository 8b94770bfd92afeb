"""The port's ``ef_update`` and ``pack_ef_cast`` against the Pallas
kernels (interpret mode) and the eager oracles of ``repro.kernels.ref``, on
the ``tests/test_kernels.py`` grid plus ragged sizes, and the wrappers'
rules.  On CPU tensors the wrapper runs its plain PyTorch version; the
CUDA kernel itself runs only on the GPU (``test_torch_cuda.py``)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rkref
from repro.kernels.ef_covap import ef_update as pallas_ef_update
from repro.kernels.pack_ef_cast import pack_ef_cast as pallas_pack_ef_cast

from repro_torch.kernels import ef_covap
from repro_torch.kernels.ef_covap import ef_update, ef_update_cuda
from repro_torch.kernels.pack_ef_cast import pack_ef_cast, pack_ef_cast_into
from repro_torch.kernels.ref import ef_update_ref, pack_ef_cast_ref

pack_mod = importlib.import_module("repro_torch.kernels.pack_ef_cast")

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


# ---- pack_ef_cast ----------------------------------------------------------

WIRES = [None, "bfloat16", "float16"]
PACK_COEFF = float(np.float32(0.7))     # exact in f32: both sides see one value


def _np(x):
    """A torch or JAX array as float32 numpy (bf16/f16 widen exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("selected", [True, False])
def test_pack_ef_cast_plain_is_the_eager_reference(selected, wire):
    """The port's plain version equals ``repro.kernels.ref.pack_ef_cast_ref``
    called eagerly (op by op, no FMA contraction) bit for bit."""
    g, r = _inputs(65_537, seed=5)
    g[:7] = [7e4, -7e4, 65504.0, 65520.0, 1e-30, 0.0, -0.0]   # f16 overflow, tiny
    want_w, want_r = rkref.pack_ef_cast_ref(
        jnp.asarray(g), jnp.asarray(r), PACK_COEFF, selected=selected,
        wire_dtype=wire)
    w, q = pack_ef_cast(torch.from_numpy(g), torch.from_numpy(r), PACK_COEFF,
                        selected=selected, wire_dtype=wire)
    assert str(w.dtype).removeprefix("torch.") == (wire or "float32")
    np.testing.assert_array_equal(_np(w), _np(want_w))
    np.testing.assert_array_equal(_np(q), _np(want_r))
    # and the same as the plain function itself, with r=None / coeff=None
    for rr, cc in ((None, None), (torch.from_numpy(r), None)):
        pw, pq = pack_ef_cast_ref(torch.from_numpy(g), rr, cc, selected=selected,
                                  wire_dtype=wire)
        rw, rq = rkref.pack_ef_cast_ref(
            jnp.asarray(g), None if rr is None else jnp.asarray(r), cc,
            selected=selected, wire_dtype=wire)
        np.testing.assert_array_equal(_np(pw), _np(rw))
        assert (pq is None) == (rq is None)
        if pq is not None:
            np.testing.assert_array_equal(_np(pq), _np(rq))


@pytest.mark.parametrize("n", [1, 4099, 65_537])
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("selected", [True, False])
def test_pack_ef_cast_matches_pallas_kernel(n, selected, wire):
    """Against the Pallas kernel in interpret mode, which contracts
    ``g + c*r`` to one FMA: ``t = wire + r'`` at rtol 1e-6, atol
    1e-6 * max|c r|; with a cast the wire values may differ by one unit in
    the wire type's last place, and only where the FMA moved ``t``."""
    g, r = _inputs(n, seed=n)
    pw, pr = pallas_pack_ef_cast(jnp.asarray(g), jnp.asarray(r), PACK_COEFF,
                                 selected=selected, wire_dtype=wire, block=4096,
                                 interpret=True)
    w, q = pack_ef_cast(torch.from_numpy(g), torch.from_numpy(r), PACK_COEFF,
                        selected=selected, wire_dtype=wire)
    t_port = _np(w) + q.numpy()
    t_pallas = _np(pw) + np.asarray(pr)
    atol = 1e-6 * float(np.max(np.abs(PACK_COEFF * r)))
    np.testing.assert_allclose(t_port, t_pallas, rtol=1e-6, atol=atol)
    if not selected:
        assert not np.any(_np(w)) and not np.any(np.asarray(pw))
        return
    if wire is None:
        assert not np.any(q.numpy()) and not np.any(np.asarray(pr))
        np.testing.assert_allclose(_np(w), _np(pw), rtol=1e-6, atol=atol)
        return
    bits = w.view(torch.int16).numpy().astype(np.int32)
    pbits = np.asarray(pw).view(np.int16).astype(np.int32)
    differ = bits != pbits
    t_moved = (_np(w).astype(np.float64) + q.numpy()) != (
        _np(pw).astype(np.float64) + np.asarray(pr))
    assert np.all(np.abs(bits - pbits)[differ] == 1)      # one ulp, same sign
    assert np.all(t_moved[differ])
    assert differ.sum() <= max(1, n // 1000)


@pytest.mark.parametrize(
    "g,r,wire_out,exc",
    [
        (torch.zeros(8, dtype=torch.bfloat16), torch.zeros(8), torch.zeros(8), TypeError),
        (torch.zeros(8), torch.zeros(8, dtype=torch.float64), torch.zeros(8), TypeError),
        (torch.zeros(8), torch.zeros(8), torch.zeros(8, dtype=torch.float64), TypeError),
        (torch.zeros(16)[::2], torch.zeros(8), torch.zeros(8), ValueError),
        (torch.zeros(8), torch.zeros(8), torch.zeros(16)[::2], ValueError),
        (torch.zeros(8), torch.zeros(9), torch.zeros(8), ValueError),
        (torch.zeros(8), torch.zeros(8), torch.zeros(9, dtype=torch.bfloat16), ValueError),
        (torch.zeros(2, 4), torch.zeros(2, 4), torch.zeros(2, 4), ValueError),
        (torch.zeros(8), torch.zeros(8), None, ValueError),
    ],
    ids=["bf16-g", "f64-residual", "f64-wire", "non-contiguous", "strided-wire",
         "shape-mismatch", "wire-shape", "not-flat", "selected-without-wire"],
)
def test_pack_ef_cast_rejects_what_the_kernel_does_not_take(g, r, wire_out, exc):
    with pytest.raises(exc):
        pack_ef_cast_into(g, r, 0.5, wire_out, torch.empty(g.shape), selected=True)


def test_pack_ef_cast_counter_stays_zero_on_cpu_and_nothing_is_built():
    before = pack_ef_cast.launches
    g, r = _inputs(100)
    for sel in (True, False):
        for wire in WIRES:
            pack_ef_cast(torch.from_numpy(g), torch.from_numpy(r), 0.5,
                         selected=sel, wire_dtype=wire)
    assert pack_ef_cast.launches == before
    assert pack_mod._launcher.cache_info().currsize == 0
    text = (pack_mod._build.CSRC / "pack_ef_cast.cu").read_text()
    assert 'extern "C" int pack_ef_cast_launch' in text
    assert "src/repro/kernels/pack_ef_cast.py::pack_ef_cast" in text


def test_pack_ef_cast_into_writes_the_given_views():
    """The arena form: the wire lands in a slot at an odd element offset of
    a bf16 plane, an unselected call leaves the plane untouched."""
    g, r = _inputs(1000, seed=9)
    gt, rt = torch.from_numpy(g), torch.from_numpy(r)
    plane = torch.full((1003,), 5.0, dtype=torch.bfloat16)
    r_out = torch.empty(1000)
    pack_ef_cast_into(gt, rt, 0.5, plane[3:], r_out, selected=True)
    w, q = pack_ef_cast_ref(gt, rt, 0.5, selected=True, wire_dtype="bfloat16")
    assert torch.equal(plane[3:], w) and torch.equal(r_out, q)
    assert torch.equal(plane[:3], torch.full((3,), 5.0, dtype=torch.bfloat16))
    before = plane.clone()
    pack_ef_cast_into(gt, rt, 0.5, None, r_out, selected=False)
    assert torch.equal(plane, before) and torch.equal(r_out, gt + 0.5 * rt)
