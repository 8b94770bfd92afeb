"""The plain references, one module a family of models, found by the
configuration: a configuration file's ``"reference"`` names the module
``bench.reference.<name>`` that describes it (``"model"``, the dense and
MoE decoder, where the file names none).

A reference module keeps this contract, and imports nothing of the system
under test:

* ``Arch.from_config(conf)``: the sizes it reads from a configuration
  file's object; a configuration the module does not describe raises;
* ``param_shapes(a)``: every parameter's shape by dotted path, in the
  order of the port's ``named_leaves()``;
* ``loss(params, tokens, labels, a, mm)``: ``(total, cross-entropy, aux
  loss, dropped assignments)`` of one batch, every matrix product through
  ``mm`` (the float8 control passes its own);
* ``step_flops(conf, *, rows, seq_len)``: the frozen FLOPs of one training
  step over ``rows`` rows (every chip's) of ``seq_len`` tokens;
* optionally ``std_of(path, shape)``: the initial standard deviation of a
  leaf, or ``None`` to leave the leaf to ``bench.weights``'s rules.

``covap``, ``data`` and ``train`` (the exchange and AdamW, the batches, the
first cycle) serve every family.
"""
from __future__ import annotations

import importlib

DEFAULT = "model"


def of(conf: dict):
    """The reference module of a configuration file's object."""
    name = conf.get("reference", DEFAULT)
    if not isinstance(name, str) or not name.isidentifier():
        raise LookupError(f"reference {name!r} is no module name")
    try:
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise LookupError(f"no reference module {name!r}: "
                          f"bench/reference/{name}.py is missing") from None
