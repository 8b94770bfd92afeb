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
from repro_torch.kernels.ref import ef_update_ref, pack_ef_cast_ref


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
