"""Config registry: ``get_config(name)`` / ``get_reduced(name)`` /
``list_archs()``.  One module per ported architecture, exporting CONFIG
and REDUCED as the reference's does.  The reference's other archs (the
VLM and audio families) raise ``NotImplementedError`` naming their
family; an unknown name raises ``KeyError``."""
from __future__ import annotations

import importlib

from .base import INPUT_SHAPES, ArchConfig, InputShape

_ARCH_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "gemma-2b": "gemma_2b",
    "grok-1-314b": "grok_1_314b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "mistral-large-123b": "mistral_large_123b",
    "xlstm-125m": "xlstm_125m",
    "gemma2-27b": "gemma2_27b",
    "zamba2-2.7b": "zamba2_2_7b",
    "gpt2-paper": "gpt2_paper",
}

# the reference's archs whose families the port does not have yet
_UNPORTED_FAMILIES = {
    "pixtral-12b": "vlm",
    "seamless-m4t-medium": "audio",
}


def list_archs(assigned_only: bool = False) -> list[str]:
    """The ported archs (``assigned_only``: without the paper's own
    ``gpt2-paper``)."""
    names = list(_ARCH_MODULES)
    if assigned_only:
        names.remove("gpt2-paper")
    return names


def _module(name: str):
    if name in _UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"arch {name!r}: family {_UNPORTED_FAMILIES[name]!r} is not ported")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"{__name__}.{_ARCH_MODULES[name]}")


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
