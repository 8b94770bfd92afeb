"""Config registry: ``get_config(name)`` / ``get_reduced(name)`` /
``list_archs()``.  Only ``gpt2-paper`` is ported so far; other names raise
``KeyError``."""
from __future__ import annotations

from . import gpt2_paper
from .base import INPUT_SHAPES, ArchConfig, InputShape

_ARCHS = {"gpt2-paper": gpt2_paper}


def list_archs() -> list[str]:
    """The ported archs."""
    return list(_ARCHS)


def _module(name: str):
    if name not in _ARCHS:
        raise KeyError(f"arch {name!r} is not ported; have {sorted(_ARCHS)}")
    return _ARCHS[name]


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _module(name).REDUCED


__all__ = [
    "ArchConfig",
    "InputShape",
    "INPUT_SHAPES",
    "get_config",
    "get_reduced",
    "list_archs",
]
