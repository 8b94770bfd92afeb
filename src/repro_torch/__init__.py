"""COVAP in PyTorch: the port of ``repro`` to PyTorch and CUDA on Hopper.

The package mirrors the JAX package's module names (``api``,
``checkpoint``, ``configs``, ``data``, ``kernels``, ``models``, ``obs``, ``optim``,
``core``, ``runtime``, ``serve``, ``train``, ``launch``) so that each module has an obvious counterpart.  It imports neither JAX nor
the JAX package.  Entry points run on the GPU (``device="cuda"``) unless
the caller passes ``device="cpu"``; they never fall back on their own.

Submodules are loaded lazily so ``import repro_torch`` stays cheap.
"""
from __future__ import annotations

import importlib

__version__ = "0.1.0"

_SUBMODULES = (
    "api",
    "checkpoint",
    "configs",
    "core",
    "data",
    "device",
    "interop",
    "kernels",
    "launch",
    "models",
    "obs",
    "optim",
    "runtime",
    "serve",
    "train",
)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
