"""The initial weights of a run, made from its seed on the device: one
``torch.Generator`` call a leaf, float32, the same numbers for the system
under test and for the reference.

Rules: the embedding N(0, 0.02); the norms' scales 0 (the decoder
multiplies by ``1 + scale``); the router N(0, 1) * 0.1 / sqrt(fan_in);
every other matrix N(0, 1) / sqrt(fan_in), ``fan_in`` the leaf's
second-to-last axis.  A reference module's own ``std_of`` (``rule``, below)
comes first where it gives a number.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit seed of leaf ``index`` of a run seeded with ``seed``."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), int(seed) >> 64, index])
    return int(state.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def std_of(path: str, shape: tuple[int, ...], rule=None) -> float:
    if rule is not None:
        std = rule(path, shape)
        if std is not None:
            return std
    if path == "embed.table":
        return 0.02
    if path.endswith(".scale"):
        return 0.0
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 0.1 if path.endswith(".router") else 1.0
    return scale / math.sqrt(fan_in)


@torch.no_grad()
def fill_leaf(out: torch.Tensor, seed: int, index: int, path: str, rule=None
              ) -> torch.Tensor:
    """Write leaf ``index`` (``path``) of the run into ``out`` (float32, any
    device) in place."""
    std = std_of(path, tuple(out.shape), rule)
    if std == 0.0:
        return out.zero_()
    gen = torch.Generator(out.device).manual_seed(leaf_seed(seed, index))
    return out.normal_(0.0, std, generator=gen)


def make_leaves(shapes: dict[str, tuple[int, ...]], seed: int, device, rule=None
                ) -> dict[str, torch.Tensor]:
    """Every leaf of ``shapes`` (path -> shape, in leaf order), new tensors."""
    return {path: fill_leaf(torch.empty(shape, dtype=torch.float32, device=device),
                            seed, i, path, rule)
            for i, (path, shape) in enumerate(shapes.items())}
