"""Parameter trees in and out of the port.

The reference keeps parameters as nested dicts of arrays
(``{"embed": {"table": ...}, "stack": {"blocks": {"b0": ...}}, ...}``).
:func:`params_from_jax` turns such a tree, with numpy arrays as leaves, into
the port's ``{dotted path: tensor}`` state dict, which
``DecoderLM.load_state_dict`` takes; :func:`params_to_numpy` is its inverse.
Neither imports JAX: the caller converts arrays with ``numpy.asarray``.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from .device import resolve_device


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "."))
        else:
            out[path] = v
    return out


def params_from_jax(tree: Mapping[str, Any], *, device="cuda") -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> ``{dotted path: tensor on device}``."""
    dev = resolve_device(device)
    return {
        path: torch.from_numpy(np.array(v, copy=True)).to(dev)
        for path, v in _flatten(tree).items()
    }


def params_to_numpy(params: nn.Module | Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """The port's parameters (a module or a dotted-path dict) -> nested dict
    of numpy arrays, the reference's tree layout."""
    flat = dict(params.named_parameters()) if isinstance(params, nn.Module) else params
    tree: dict[str, Any] = {}
    for path, t in flat.items():
        node = tree
        *heads, leaf = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = t.detach().cpu().numpy()
    return tree
