"""Parameter trees in and out of the port.

The reference keeps parameters as nested dicts of arrays
(``{"embed": {"table": ...}, "stack": {"blocks": {"b0": ...}}, ...}``).
:func:`params_from_jax` turns such a tree, with numpy arrays as leaves, into
the port's ``{dotted path: tensor}`` state dict, which
``DecoderLM.load_state_dict`` takes; :func:`params_to_numpy` is its inverse.
:func:`compressor_state_from_jax` carries a leaf-granularity compressor's
state (PowerSGD's ``{"q": [...], "residual": [...]}``) over the same way.
:func:`caches_from_jax` and :func:`caches_to_numpy` carry serving state
both ways — cache trees and arena planes, bf16 and int8 leaves included —
keeping its nesting.  None imports JAX: the caller converts arrays with
``numpy.asarray``.
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


def _tensor(v) -> torch.Tensor:
    """A numpy array as a tensor of its dtype; a bfloat16 array (numpy's
    ``ml_dtypes`` extension type, which ``torch.from_numpy`` refuses) goes
    across through its 16-bit pattern."""
    a = np.array(v, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: Mapping[str, Any], *, device="cuda") -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> ``{dotted path: tensor on device}``."""
    dev = resolve_device(device)
    return {path: _tensor(v).to(dev) for path, v in _flatten(tree).items()}


def params_to_numpy(params: nn.Module | Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """The port's parameters (a module or a dotted-path dict) -> nested dict
    of numpy arrays, the reference's tree layout (bf16 leaves as
    ``ml_dtypes.bfloat16``, as :func:`caches_to_numpy` gives them)."""
    flat = dict(params.named_parameters()) if isinstance(params, nn.Module) else params
    tree: dict[str, Any] = {}
    for path, t in flat.items():
        node = tree
        *heads, leaf = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = _array(t)
    return tree


def compressor_state_from_jax(state: Mapping[str, Any], *, device="cuda"
                              ) -> dict[str, list[torch.Tensor | None]]:
    """The reference's PowerSGD state, ``{"q": [...], "residual": [...]}``
    with numpy arrays (or ``None``) in leaf order, as the port's: the same
    keys and lists, each array a tensor on ``device``, each ``None`` kept."""
    dev = resolve_device(device)
    return {
        key: [None if v is None else _tensor(v).to(dev) for v in values]
        for key, values in state.items()
    }



def _map_tree(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def caches_from_jax(tree, *, device="cuda"):
    """A cache tree or a list of arena planes with numpy leaves (bf16 as
    ``ml_dtypes.bfloat16``, as ``numpy.asarray`` gives them from JAX) ->
    the same nesting with tensors on ``device``."""
    dev = resolve_device(device)
    return _map_tree(lambda v: _tensor(v).to(dev), tree)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, as JAX returns it; installed with JAX

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def caches_to_numpy(tree):
    """The port's cache tree or arena planes -> the same nesting with numpy
    arrays, bf16 leaves as ``ml_dtypes.bfloat16`` (what the reference's
    ``jnp.asarray`` takes)."""
    return _map_tree(_array, tree)
