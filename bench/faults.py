"""Faults planted in the system under test, to show that the comparison
catches them; the benchmark's own runs never plant one.  Each takes the
built :class:`bench.harness.Program` before its first step and returns an
undo callable.

* ``unchanged``: every step returns the state it was given (the optimizer
  returns its state as it got it, and zero updates);
* ``half_batch``: the loss is the mean over the first half of each batch's
  rows, the rest left out;
* ``no_exchange``: the all-reduce between the chips is left out, so each
  chip steps on its own gradients;
* ``altered``: the loss is altered by 1% where the model produces it (and
  with it every gradient);
* ``residual``: the error-feedback residuals of the buckets first
  exchanged at the cycle's last step (a quarter of the model at I = 4) are
  dropped after every step, so their sends carry none of the steps before.
"""
from __future__ import annotations

import torch


def unchanged(prog):
    from repro_torch.optim import Optimizer

    tr = prog.trainer
    saved = tr.optimizer

    def update(grads, state, params):
        return [torch.zeros_like(p) for p in params], state

    tr.optimizer = Optimizer(saved.init, update)
    return lambda: setattr(tr, "optimizer", saved)


def half_batch(prog):
    model = prog.model
    saved = model.loss_fn

    def loss_fn(batch, *a, **k):
        return saved({n: v[: v.shape[0] // 2] for n, v in batch.items()}, *a, **k)

    model.loss_fn = loss_fn
    return lambda: setattr(model, "loss_fn", saved)


def no_exchange(prog):
    from repro_torch.core import stages

    saved = stages.start_pmean
    stages.start_pmean = lambda x, group: None
    return lambda: setattr(stages, "start_pmean", saved)


def altered(prog):
    model = prog.model
    saved = model.loss_fn

    def loss_fn(*a, **k):
        total, metrics = saved(*a, **k)
        return total * 1.01, metrics

    model.loss_fn = loss_fn
    return lambda: setattr(model, "loss_fn", saved)


def residual(prog):
    from .yardstick.ef_bytes import plan_of

    buckets, _ = plan_of(prog.cell.conf, prog.cell.traffic)
    interval = prog.cell.traffic["interval"]
    segs = [seg for b, bucket in enumerate(buckets) if (b + interval - 1) % interval == 0
            for seg in bucket]
    tr = prog.trainer
    saved = tr.step

    def step(state, batch):
        state, metrics = saved(state, batch)
        with torch.no_grad():
            for seg in segs:
                seg.view(state["comp"][seg.leaf]).zero_()
        return state, metrics

    tr.step = step
    return lambda: setattr(tr, "step", saved)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "no_exchange": no_exchange,
          "altered": altered, "residual": residual}
