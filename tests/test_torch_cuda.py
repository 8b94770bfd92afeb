"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: each test skips where there is no GPU, since a CUDA kernel
has no CPU mode.  The file imports neither JAX nor the reference, so it runs
on a GPU machine that has neither:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.ef_covap import ef_update
from repro_torch.kernels.pack_ef_cast import pack_ef_cast, pack_ef_cast_into
from repro_torch.kernels.quantize import dequantize_fp8, quantize_fp8
from repro_torch.kernels.ref import (
    dequantize_fp8_ref,
    ef_update_ref,
    pack_ef_cast_ref,
    quantize_fp8_ref,
    sign_compress_partials_ref,
)
from repro_torch.kernels.sign_compress import sign_compress, sign_compress_partials


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1_000_003, 0), (4096, 1), (6_553_344, 0)])
@pytest.mark.parametrize("selected", [True, False])
def test_cuda_kernel_matches_plain_version(n, offset, selected):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(n)
    g = torch.randn(n + offset, generator=gen, device="cuda")[offset:]
    r = torch.randn(n + offset, generator=gen, device="cuda")[offset:]
    before = ef_update.launches
    s, q = ef_update(g, r, 0.3, selected=selected)
    torch.cuda.synchronize()
    assert ef_update.launches == before + 1
    rs, rq = ef_update_ref(g, r, 0.3, selected=selected)
    assert torch.equal(s, rs) and torch.equal(q, rq)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset,wire_offset",
                         [(1_000_003, 0, 0), (4099, 1, 0), (65_537, 0, 1),
                          (6_553_344, 0, 3)])
@pytest.mark.parametrize("wire", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("selected", [True, False])
def test_pack_ef_cast_kernel_matches_plain_version(n, offset, wire_offset, wire,
                                                   selected):
    """Bitwise, with the wire written into a plane at an element offset (the
    arena slot) and views that start off a 16-byte boundary."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(n)
    g = torch.randn(n + offset, generator=gen, device="cuda")[offset:] * 3e4
    r = torch.randn(n + offset, generator=gen, device="cuda")[offset:]
    plane = torch.zeros(n + wire_offset, dtype=wire, device="cuda")
    r_out = torch.empty(n, device="cuda")
    before = pack_ef_cast.launches
    pack_ef_cast_into(g, r, 0.3, plane[wire_offset:] if selected else None,
                      r_out, selected=selected)
    torch.cuda.synchronize()
    assert pack_ef_cast.launches == before + 1
    w, q = pack_ef_cast_ref(g, r, 0.3, selected=selected, wire_dtype=wire)
    assert torch.equal(r_out, q)
    if selected:
        assert torch.equal(plane[wire_offset:], w)
    assert not torch.any(plane[:wire_offset] != 0)
    if not selected:
        assert not torch.any(plane != 0)


def _same_floats(a, b):
    """Bit for bit, where NaN counts as equal to NaN (the card's arithmetic
    returns one canonical NaN, but the test should not depend on it)."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _fp8_input(n, offset, gen):
    """Normals at scales from e^-8 to e^8 in a plane, viewed from element
    ``offset``."""
    x = torch.randn(n + offset, generator=gen, device="cuda")
    x = x * torch.exp(torch.rand(n + offset, generator=gen, device="cuda") * 16 - 8)
    x = x[offset:]
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("n,block,offset,special",
                         [(1_000_003, 8192, 0, False), (5000, 8192, 0, False),
                          (10_007, 64, 0, True), (100_003, 8192, 1, True),
                          (6_553_344, 8192, 0, False)])
def test_quantize_fp8_kernels_match_plain_version(n, block, offset, special):
    """q and scales bit for bit against ``quantize_fp8_ref``, the dequantised
    values against ``dequantize_fp8_ref``: ragged, N < block, block 64, an
    offset-1 view, the largest bucket, and blocks that are zero, hold a NaN,
    hold +-inf, or hold 448 beside values that quantize to subnormals."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(n + block)
    x = _fp8_input(n, offset, gen)
    if special:
        x[:block] = 0.0
        x[block + 3] = float("nan")
        x[2 * block + 1], x[2 * block + 2] = float("inf"), float("-inf")
        x[3 * block:4 * block] *= 1e-3 / x[3 * block:4 * block].abs().max()
        x[3 * block], x[3 * block + 1] = 448.0, -0.0
    b = (quantize_fp8.launches, dequantize_fp8.launches)
    q, s = quantize_fp8(x, block)
    d = dequantize_fp8(q, s, block)
    torch.cuda.synchronize()
    assert (quantize_fp8.launches, dequantize_fp8.launches) == (b[0] + 1, b[1] + 1)
    rq, rs = quantize_fp8_ref(x, block)
    assert torch.equal(q.view(torch.uint8), rq.view(torch.uint8))
    assert _same_floats(s, rs)
    assert _same_floats(d, dequantize_fp8_ref(rq, rs, block))
    if special:
        assert s[0] == 1e-12 and torch.isnan(s[1]) and torch.isinf(s[2])
        assert s[3] == 1.0 and d[3 * block] == 448.0
        assert bool(((q[3 * block:4 * block].view(torch.uint8) & 0x78) == 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1_000_003, 0), (4099, 1), (6_553_344, 0),
                                      (32_768, 3)])
def test_sign_compress_kernel_matches_plain_version(n, offset):
    """Signs bit for bit (+0.0 and -0.0 give +1, NaN and negative subnormals
    -1); partials and scale at rtol 1e-6 (another order of summation)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(n)
    x = torch.randn(n + offset, generator=gen, device="cuda")[offset:]
    special = torch.tensor([0.0, -0.0, 1e-45, -1e-45, float("nan")], device="cuda")
    xs = x.clone()
    xs[:5] = special[:min(5, n)]
    before = sign_compress.launches
    signs, _ = sign_compress_partials(xs)
    signs2, scale = sign_compress(x)
    torch.cuda.synchronize()
    assert sign_compress.launches == before + 2
    rsigns, _ = sign_compress_partials_ref(xs)
    assert torch.equal(signs, rsigns)
    assert signs[:5].tolist() == [1, 1, 1, -1, -1]
    rs2, rpartials = sign_compress_partials_ref(x)
    assert torch.equal(signs2, rs2)
    _, partials = sign_compress_partials(x)
    torch.testing.assert_close(partials, rpartials, rtol=1e-6, atol=0)
    torch.testing.assert_close(scale, x.abs().mean(), rtol=1e-6, atol=0)
