"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: each test skips where there is no GPU, since a CUDA kernel
has no CPU mode.  The file imports neither JAX nor the reference, so it runs
on a GPU machine that has neither:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.ef_covap import ef_update
from repro_torch.kernels.ref import ef_update_ref


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
