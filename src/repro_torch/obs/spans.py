"""Spans and counters inside the training step, on the profiler's clock.

:func:`span` names a region of the host's work.  While a ``torch.profiler``
records, it is a ``torch.profiler.record_function`` range: the range lands
in the same trace as the CUDA kernels its calls launch (a kernel and its
launch share a correlation id), on the same clock, and nested ranges give
each span its parent.  While none records, it is one check of PyTorch's
own flag and a shared no-op context: no ``record_function``, no
allocation, and the step runs the arithmetic and launches it runs without
it.

:func:`count` keeps a value for a process-wide total, again only while a
profiler records.  A value may be a device tensor, or a function that
computes one from tensors of the step; either is kept as it is, so
counting neither waits for the device nor launches a kernel inside the
step.  :func:`counters` computes and adds the values up after the profiled
window (it launches and synchronises then), :func:`reset_counters` clears
them.

The step's spans (``PERF.md`` lists each with the metric that reads it):
``train/forward``, ``train/backward``, ``train/sync``, ``train/optimizer``,
``train/metrics``, the fused overlap's ``covap_bucket_{b}/phase_{p}``,
``moe/route``, ``moe/dispatch``, ``moe/experts``, ``moe/combine``, latent
attention's ``mla/latent`` and ``mla/attend``, ``data/draw``,
``data/copy``; the counters ``moe/assigned`` and ``moe/dropped``,
``moe/held`` (the assignments to the experts a layer holding a share
holds), ``optim/params`` and ``optim/fused_params`` (the parameters
``Optimizer.apply`` stepped, and those its CUDA kernel stepped).
"""
from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

# the name prefixes of the step's span families (the module notes list
# each span), by which ``launch.profile_train`` reads a trace
SPAN_FAMILIES = ("train/", "moe/", "mla/", "data/", "covap_bucket_")

_OFF = contextlib.nullcontext()
_values: dict[str, list] = {}


def recording() -> bool:
    """Whether a profiler records now (``torch.profiler.profile`` sets the
    flag on entry and clears it on exit)."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A context manager over a region named ``name``: a profiler range
    while a profiler records, a shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, value) -> None:
    """Keep ``value`` for the total ``name`` while a profiler records;
    nothing otherwise.  ``value`` is a Python number, a tensor (its sum
    counts) or a function of no arguments that returns one of the two
    (called by :func:`counters`)."""
    if not _profiler._is_profiler_enabled:
        return
    if isinstance(value, torch.Tensor):
        value = value.detach()
    _values.setdefault(name, []).append(value)


def _total(v) -> float:
    v = v() if callable(v) else v
    return float(v.sum()) if isinstance(v, torch.Tensor) else float(v)


def counters() -> dict[str, float]:
    """The totals as floats: computes what :func:`count` kept, on the
    device where it lives, and synchronises."""
    return {k: sum(_total(v) for v in vs) for k, vs in _values.items()}


def reset_counters() -> None:
    _values.clear()


__all__ = ["SPAN_FAMILIES", "count", "counters", "recording", "reset_counters", "span"]
