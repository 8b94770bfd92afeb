"""Config registry: ``get_config(name)`` / ``get_reduced(name)`` /
``list_archs()``.  One module per architecture (the ten assigned archs,
the paper's own GPT-2, and the archs only the port has), exporting CONFIG
and REDUCED as the reference's does, listed in the reference's order and
then the port's own (:data:`PORT_ONLY`); an unknown name raises
``KeyError``."""
from __future__ import annotations

import importlib

from .base import INPUT_SHAPES, ArchConfig, InputShape

_ARCH_MODULES = {
    "pixtral-12b": "pixtral_12b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "gemma-2b": "gemma_2b",
    "grok-1-314b": "grok_1_314b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "mistral-large-123b": "mistral_large_123b",
    "xlstm-125m": "xlstm_125m",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "gemma2-27b": "gemma2_27b",
    "zamba2-2.7b": "zamba2_2_7b",
    "gpt2-paper": "gpt2_paper",
    "moonlight-16b-a3b": "moonlight_16b_a3b",
}
# the archs the JAX reference does not have: held against their own plain
# references (``bench/reference/moonlight.py``), not against ``repro``
PORT_ONLY = ("moonlight-16b-a3b",)


def list_archs(assigned_only: bool = False) -> list[str]:
    """Every arch (``assigned_only``: without the paper's own
    ``gpt2-paper``)."""
    names = list(_ARCH_MODULES)
    if assigned_only:
        names.remove("gpt2-paper")
    return names


def reference_archs(assigned_only: bool = False) -> list[str]:
    """:func:`list_archs` without :data:`PORT_ONLY`: the reference's list."""
    return [a for a in list_archs(assigned_only) if a not in PORT_ONLY]


def _module(name: str):
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
    "PORT_ONLY",
    "get_config",
    "get_reduced",
    "list_archs",
    "reference_archs",
]
