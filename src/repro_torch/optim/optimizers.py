"""Optimizers over lists of tensors in leaf order: SGD+momentum and
Adam/AdamW, the counterparts of ``repro.optim.optimizers``.

``Optimizer`` is an ``(init, update)`` pair, as in the reference::

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    apply_updates(params, updates)

plus ``opt.apply(grads, state, params) -> state``, the step the trainer
takes, in place.  By default it is ``update`` followed by
``apply_updates``; AdamW's runs one CUDA kernel a leaf on the card
(``kernels/adamw_fused.py``), which writes the moments and the parameters
where they lie and gives the bits ``update`` + ``apply_updates`` give there.

Step counts, bias corrections and learning rates are computed on the host
in float32 (``numpy.float32`` arithmetic, the reference's f32 scalar math),
so an update issues no device-to-host synchronisation.  AdamW's bias
corrections then go to the parameters' device as 0-dim float32 tensors, so
that the card divides by them as the reference does.  ``apply_updates``
writes into the parameters in place; the arithmetic is the reference's
``p + u``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..kernels.adamw_fused import adamw_fused
from ..obs.spans import count, recording
from .clip import global_norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[list[torch.Tensor]], Any]
    update: Callable[..., tuple[list[torch.Tensor], Any]]
    # the in-place step for leaves on a CUDA card, where the optimizer has a
    # kernel for it: (grads, state, params, norm) -> (state, norm or None)
    cuda_apply: Callable[..., tuple[Any, torch.Tensor | None]] | None = None

    @torch.no_grad()
    def apply(self, grads, state, params, *, with_norm: bool = False):
        """One step, the parameters written in place (and the state too, on
        the card, where ``cuda_apply`` runs).  -> the new state; with
        ``with_norm=True``, ``(state, global_norm(grads))``, the norm taken
        from the step's own read of the gradients where ``cuda_apply``
        runs.  While a profiler records, counts the parameters stepped
        (``optim/params``) and those stepped by ``cuda_apply``
        (``optim/fused_params``)."""
        fused = (self.cuda_apply is not None and bool(params)
                 and params[0].device.type == "cuda")
        if fused:
            state, norm = self.cuda_apply(grads, state, params, with_norm)
        else:
            norm = global_norm(grads) if with_norm else None
            updates, state = self.update(grads, state, params)
            apply_updates(params, updates)
        if recording():
            n = sum(p.numel() for p in params)
            count("optim/params", n)
            count("optim/fused_params", n if fused else 0)
        return (state, norm) if with_norm else state


def _sched(lr):
    return lr if callable(lr) else (lambda step: np.float32(lr))


def sgd(lr, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    lr_fn = _sched(lr)

    def init(params):
        return {
            "step": 0,
            "mu": [torch.zeros_like(p) for p in params] if momentum else [],
        }

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        if momentum:
            mu = [momentum * m + g.to(m.dtype) for m, g in zip(state["mu"], grads)]
            upd = (
                [momentum * m + g.to(m.dtype) for m, g in zip(mu, grads)]
                if nesterov else mu
            )
            new_state = {"step": step, "mu": mu}
        else:
            upd = grads
            new_state = {"step": step, "mu": []}
        lr = float(lr_fn(step))
        return [-lr * u.float() for u in upd], new_state

    return Optimizer(init, update)


def bias_corrections(step: int, b1: float, b2: float, device
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Adam's ``1 - b1**t`` and ``1 - b2**t`` at ``t = step``, computed in
    numpy float32 as the reference computes them, as 0-dim float32 tensors
    on ``device``.  On CUDA, division by a CPU scalar (a Python float or a
    0-dim CPU tensor) becomes a multiplication by its reciprocal, which can
    differ from the reference's division by an ulp; a device tensor is
    divided by.  Each is a fill, not a host-to-device copy, so the host
    does not wait for the device."""
    t = np.float32(step)
    return tuple(torch.full((), float(np.float32(1) - np.float32(b) ** t),
                            dtype=torch.float32, device=device)
                 for b in (b1, b2))


def adamw(
    lr,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    moment_dtype: str | None = None,
) -> Optimizer:
    """Adam/AdamW.  The moments are kept in ``moment_dtype`` (a torch dtype
    name), by default in each parameter's own dtype (bf16 moments for bf16
    parameters, as in the reference); the update is computed in f32.  On
    the card ``apply`` writes the new moments into the state's own tensors
    (``kernels.adamw_fused``); ``update`` returns new ones."""
    lr_fn = _sched(lr)

    def _zeros(p):
        dt = getattr(torch, moment_dtype) if moment_dtype else p.dtype
        return torch.zeros_like(p, dtype=dt)

    def init(params):
        return {
            "step": 0,
            "m": [_zeros(p) for p in params],
            "v": [_zeros(p) for p in params],
        }

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        m = [
            (b1 * m_.float() + (1 - b1) * g.float()).to(m_.dtype)
            for m_, g in zip(state["m"], grads)
        ]
        v = [
            (b2 * v_.float() + (1 - b2) * torch.square(g.float())).to(v_.dtype)
            for v_, g in zip(state["v"], grads)
        ]
        bc1, bc2 = bias_corrections(step, b1, b2, m[0].device if m else None)
        lr = float(lr_fn(step))

        def upd(m_, v_, p):
            mh = m_.float() / bc1
            vh = v_.float() / bc2
            u = mh / (torch.sqrt(vh) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return -lr * u

        updates = [upd(m_, v_, p) for m_, v_, p in zip(m, v, params)]
        return updates, {"step": step, "m": m, "v": v}

    def cuda_apply(grads, state, params, norm):
        step = state["step"] + 1
        bc1, bc2 = bias_corrections(step, b1, b2, params[0].device)
        gnorm = adamw_fused(params, grads, state["m"], state["v"], bc1, bc2,
                            lr=float(lr_fn(step)), b1=b1, b2=b2, eps=eps,
                            weight_decay=weight_decay, norm=norm)
        return {"step": step, "m": state["m"], "v": state["v"]}, gnorm

    return Optimizer(init, update, cuda_apply)


@torch.no_grad()
def apply_updates(params: list[torch.Tensor], updates: list[torch.Tensor]) -> None:
    """``p <- p + u`` in place (``(p.float() + u).to(p.dtype)`` for
    narrower parameter dtypes)."""
    for p, u in zip(params, updates):
        if p.dtype == torch.float32:
            p.add_(u)
        else:
            p.copy_((p.float() + u).to(p.dtype))
