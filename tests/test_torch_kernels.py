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


# ---- quantize_fp8 / dequantize_fp8 and sign_compress ------------------------

from repro.kernels.quantize import dequantize_fp8 as pallas_dequantize_fp8  # noqa: E402
from repro.kernels.quantize import quantize_fp8 as pallas_quantize_fp8  # noqa: E402
from repro.kernels.sign_compress import sign_compress as pallas_sign_compress  # noqa: E402

from repro_torch.kernels.quantize import dequantize_fp8, quantize_fp8  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    dequantize_fp8_ref,
    quantize_fp8_ref,
    sign_compress_partials_ref,
    sign_compress_ref,
    sign_decompress,
)
from repro_torch.kernels.sign_compress import (  # noqa: E402
    sign_compress,
    sign_compress_partials,
)

quant_mod = importlib.import_module("repro_torch.kernels.quantize")
sign_mod = importlib.import_module("repro_torch.kernels.sign_compress")

# (name, n, block): ragged, N < block, block 64, and a vector with a zero
# block, a NaN block and an inf block
FP8_CASES = [
    ("ragged", 100_003, 8192),
    ("below-block", 5000, 8192),
    ("block-64", 10_007, 64),
    ("zero-nan-inf", 6 * 8192 + 5, 8192),
]
FP8_IDS = [c[0] for c in FP8_CASES]


def _fp8_input(name, n, block, seed=0):
    """Normals at scales from e^-8 to e^8 (subnormal fp8 results included);
    the special case zeroes block 1, puts a NaN in block 2, +inf and -inf in
    block 3 and values at 448 and below 2^-9 of it in block 4."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))).astype(np.float32)
    if name == "zero-nan-inf":
        x[block:2 * block] = 0.0
        x[2 * block + 17] = np.nan
        x[3 * block + 5], x[3 * block + 9] = np.inf, -np.inf
        x[4 * block:5 * block] = rng.standard_normal(block).astype(np.float32) * 1e-3
        x[4 * block], x[4 * block + 1], x[4 * block + 2] = 448.0, -448.0, -0.0
    return x


def _bits8(q):
    return (q.view(torch.uint8).numpy() if isinstance(q, torch.Tensor)
            else np.asarray(q).view(np.uint8))


@pytest.mark.parametrize("name,n,block", FP8_CASES, ids=FP8_IDS)
def test_quantize_fp8_plain_is_the_eager_reference(name, n, block):
    """The port's plain quantize and dequantize equal
    ``repro.kernels.ref.quantize_fp8_ref`` / ``dequantize_fp8_ref`` run
    eagerly bit for bit: q and scales (NaN where the block holds a NaN, inf
    where it holds an inf, 1e-12 for the zero block) and the dequantised
    values."""
    x = _fp8_input(name, n, block)
    q, s = quantize_fp8_ref(torch.from_numpy(x), block)
    rq, rs = rkref.quantize_fp8_ref(jnp.asarray(x), block=block)
    assert q.dtype == torch.float8_e4m3fn and q.shape == (n,)
    assert s.shape == (-(-n // block),)
    np.testing.assert_array_equal(_bits8(q), _bits8(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    d = dequantize_fp8_ref(q, s, block)
    rd = rkref.dequantize_fp8_ref(rq, rs, block=block)
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    if name == "zero-nan-inf":
        assert s[1] == np.float32(1e-12)
        assert torch.isnan(s[2]) and s[3] == float("inf")
        assert s[4] == 1.0 and float(d[4 * block]) == 448.0
        assert ((_bits8(q)[4 * block:5 * block] & 0x78) == 0).sum() > 0  # subnormals
    # the wrapper on CPU tensors is the plain version
    wq, ws = quantize_fp8(torch.from_numpy(x), block)
    assert np.array_equal(_bits8(wq), _bits8(q)) and torch.equal(ws.nan_to_num(), s.nan_to_num())
    assert torch.equal(dequantize_fp8(wq, ws, block).nan_to_num(), d.nan_to_num())


@pytest.mark.parametrize("name,n,block", FP8_CASES[:3], ids=FP8_IDS[:3])
def test_quantize_fp8_matches_pallas_kernel(name, n, block):
    """Against the Pallas kernels in interpret mode.  Under ``jax.jit`` XLA
    turns ``amax / 448`` into ``amax * (1/448)``, so a scale may differ by
    one ulp; a q may then differ by one fp8 step, where ``x / scale`` lies
    within an ulp of a rounding boundary: at most n/10000 elements.
    Dequantised values differ by at most one fp8 step of the block's
    scale."""
    x = _fp8_input(name, n, block, seed=1)
    pq, ps = pallas_quantize_fp8(jnp.asarray(x), block=block, interpret=True)
    q, s = quantize_fp8(torch.from_numpy(x), block)
    sb, psb = s.numpy().view(np.int32), np.asarray(ps).view(np.int32)
    assert np.all(np.abs(sb.astype(np.int64) - psb) <= 1)
    qb, pqb = _bits8(q).astype(np.int32), _bits8(pq).astype(np.int32)
    differ = qb != pqb
    assert np.all(np.abs(qb - pqb)[differ] == 1)          # adjacent codes, same sign
    assert differ.sum() <= n // 10_000
    pd = pallas_dequantize_fp8(pq, ps, block=block, interpret=True)
    d = dequantize_fp8(q, s, block)
    step = np.repeat(s.numpy(), block)[:n] * 32.0          # the widest e4m3 step
    assert np.all(np.abs(d.numpy() - np.asarray(pd)) <= step)
    np.testing.assert_array_equal(
        dequantize_fp8(torch.from_numpy(pqb.astype(np.uint8)).view(torch.float8_e4m3fn),
                       torch.from_numpy(np.asarray(ps).copy()), block).numpy(),
        np.asarray(pd))


def _sign_input(n, seed=0):
    """Normals with ``+0.0``, ``-0.0`` and a NaN in front (as far as n
    reaches).  No subnormals: XLA on the CPU flushes them to zero, so the
    reference gives ``-1e-45`` the sign +1 where ``x >= 0`` gives -1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    head = np.array([0.0, -0.0, np.nan], np.float32)[:n]
    x[:head.size] = head
    return x


@pytest.mark.parametrize("n", [1, 4099, 32_768, 100_003])
def test_sign_compress_plain_is_the_eager_reference(n):
    """Signs bit for bit (``-0.0`` gives +1, NaN gives -1), scale at rtol
    1e-6 (NaN-free input: the sums run in another order)."""
    x = _sign_input(n)
    signs, scale = sign_compress_ref(torch.from_numpy(x))
    rsigns, rscale = rkref.sign_compress_ref(jnp.asarray(x))
    assert signs.dtype == torch.int8
    np.testing.assert_array_equal(signs.numpy(), np.asarray(rsigns))
    if n >= 3:
        assert signs[:3].tolist() == [1, 1, -1]
    tiny = torch.tensor([1e-45, -1e-45, 1e-38, -1e-38])       # subnormal f32
    assert sign_compress_ref(tiny)[0].tolist() == [1, -1, 1, -1]
    finite = np.where(np.isnan(x), 1.0, x).astype(np.float32)
    _, scale = sign_compress_ref(torch.from_numpy(finite))
    _, rscale = rkref.sign_compress_ref(jnp.asarray(finite))
    np.testing.assert_allclose(float(scale), float(rscale), rtol=1e-6)
    np.testing.assert_array_equal(
        sign_decompress(signs, scale).numpy(),
        signs.numpy().astype(np.float32) * np.float32(scale))


@pytest.mark.parametrize("n", [1, 4099, 100_003])
def test_sign_compress_matches_pallas_kernel(n):
    """The kernel's function (signs + per-32768-block ``sum|x|`` partials,
    scale = ``sum(partials) / n``) against the Pallas kernel in interpret
    mode: signs bit for bit, partials-derived scale at rtol 1e-6."""
    x = _sign_input(n, seed=2)
    x[np.isnan(x)] = 0.5                                 # a NaN-free scale
    psigns, pscale = pallas_sign_compress(jnp.asarray(x), interpret=True)
    signs, scale = sign_compress(torch.from_numpy(x))
    np.testing.assert_array_equal(signs.numpy(), np.asarray(psigns))
    np.testing.assert_allclose(float(scale), float(pscale), rtol=1e-6)
    ps, partials = sign_compress_partials_ref(torch.from_numpy(x))
    assert torch.equal(ps, signs) and partials.shape == (-(-n // 32768),)
    _, mean = sign_compress_ref(torch.from_numpy(x))
    np.testing.assert_allclose(float(scale), float(mean), rtol=1e-6)


def test_wire_kernel_outputs_land_in_the_given_views():
    """``quantize_fp8`` writes q and scales into caller views (an odd
    element offset of a plane), ``dequantize_fp8`` into ``out``,
    ``sign_compress`` its signs into ``signs_out``; nothing outside them
    changes."""
    x = torch.from_numpy(_fp8_input("ragged", 3000, 64))
    qplane = torch.zeros(3003, dtype=torch.uint8)
    splane = torch.full((50,), 7.0)
    q, s = quantize_fp8(x, 64, q_out=qplane[3:].view(torch.float8_e4m3fn),
                        scales_out=splane[1:48])
    rq, rs = quantize_fp8_ref(x, 64)
    assert np.array_equal(_bits8(rq), qplane[3:].numpy()) and torch.equal(splane[1:48], rs)
    assert not qplane[:3].any() and splane[0] == 7.0 and torch.all(splane[48:] == 7.0)
    out = torch.full((3001,), 9.0)
    dequantize_fp8(q, s, 64, out=out[1:])
    assert torch.equal(out[1:], dequantize_fp8_ref(rq, rs, 64)) and out[0] == 9.0
    sig = torch.zeros(3002, dtype=torch.int8)
    sign_compress(x, signs_out=sig[2:])
    assert torch.equal(sig[2:], sign_compress_ref(x)[0]) and not sig[:2].any()


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda: quantize_fp8(torch.zeros(8, dtype=torch.float64)), TypeError),
        (lambda: quantize_fp8(torch.zeros(2, 4)), ValueError),
        (lambda: quantize_fp8(torch.zeros(16)[::2]), ValueError),
        (lambda: quantize_fp8(torch.zeros(8), 0), ValueError),
        (lambda: quantize_fp8(torch.zeros(8), 4, scales_out=torch.zeros(3)), ValueError),
        (lambda: quantize_fp8(torch.zeros(8), q_out=torch.zeros(8)), TypeError),
        (lambda: dequantize_fp8(torch.zeros(8), torch.ones(1)), TypeError),
        (lambda: dequantize_fp8(torch.zeros(8, dtype=torch.float8_e4m3fn),
                                torch.ones(2), 8), ValueError),
        (lambda: dequantize_fp8(torch.zeros(8, dtype=torch.float8_e4m3fn),
                                torch.ones(1), 8, out=torch.zeros(7)), ValueError),
        (lambda: sign_compress(torch.zeros(8, dtype=torch.bfloat16)), TypeError),
        (lambda: sign_compress(torch.zeros(8), signs_out=torch.zeros(8)), TypeError),
        (lambda: sign_compress_partials(torch.zeros(8), -1), ValueError),
    ],
    ids=["q-f64", "q-not-flat", "q-strided", "q-block-0", "q-scales-shape",
         "q-out-dtype", "dq-dtype", "dq-scales-shape", "dq-out-shape",
         "sign-bf16", "sign-out-dtype", "sign-block"],
)
def test_wire_kernels_reject_what_they_do_not_take(call, exc):
    with pytest.raises(exc):
        call()


def test_wire_kernel_counters_stay_zero_on_cpu_and_nothing_is_built():
    before = (quantize_fp8.launches, dequantize_fp8.launches, sign_compress.launches)
    x = torch.from_numpy(_fp8_input("ragged", 5000, 64))
    q, s = quantize_fp8(x, 64)
    dequantize_fp8(q, s, 64)
    sign_compress(x)
    sign_compress_partials(x)
    assert (quantize_fp8.launches, dequantize_fp8.launches,
            sign_compress.launches) == before
    assert quant_mod._launchers.cache_info().currsize == 0
    assert sign_mod._launcher.cache_info().currsize == 0
    for src, marks in (
        ("quantize_fp8.cu", ('extern "C" int quantize_fp8_launch',
                             'extern "C" int dequantize_fp8_launch',
                             "src/repro/kernels/quantize.py::quantize_fp8",
                             "src/repro/kernels/quantize.py::dequantize_fp8")),
        ("sign_compress.cu", ('extern "C" int sign_compress_launch',
                              "src/repro/kernels/sign_compress.py::sign_compress")),
    ):
        text = (quant_mod._build.CSRC / src).read_text()
        assert all(m in text for m in marks), src
