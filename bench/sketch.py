"""Random projections of a leaf: ``K`` dot products with Gaussian vectors
drawn from the run's seed, accumulated in float64.  For two tensors ``x``
and ``y`` of one leaf the projections' root-mean-square difference
estimates ``|x - y|`` (each projection of ``x - y`` is N(0, |x - y|^2)), so
a leaf's first gradient can be compared element by element without keeping
both gradients."""
from __future__ import annotations

import numpy as np
import torch

K = 8
CHUNK = 1 << 24
STREAM = 0x5CE7C4


def _seed(seed: int, leaf: int, j: int, chunk: int) -> int:
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), int(seed) >> 64, STREAM,
                                    leaf, j, chunk])
    return int(state.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


@torch.no_grad()
def project(x: torch.Tensor, seed: int, leaf: int, k: int = K) -> list[float]:
    """``x`` (any shape, on its device) against the seed's ``k`` vectors of
    leaf ``leaf``."""
    flat = x.reshape(-1)
    out = []
    for j in range(k):
        acc = torch.zeros((), dtype=torch.float64, device=x.device)
        for c, lo in enumerate(range(0, flat.numel(), CHUNK)):
            part = flat[lo:lo + CHUNK]
            gen = torch.Generator(x.device).manual_seed(_seed(seed, leaf, j, c))
            r = torch.randn(part.numel(), dtype=torch.float32, device=x.device,
                            generator=gen)
            acc += torch.dot(part.double(), r.double())
        out.append(float(acc))
    return out
