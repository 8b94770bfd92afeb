"""The port's library surface: ``repro_torch.api.fit`` and
``plan_report`` (the counterpart of ``repro.api``; ``tune`` waits for the
perf model, ``ROADMAP.md`` queue 1 "CCR, perf model and adaptive
runtime").

* :func:`fit` trains an architecture with a registered compressor.
  ``interval="auto"`` resolves the paper's adaptive rule ``I =
  ceil(analytic_ccr)`` (SS III.B) before the first step.
* :func:`plan_report` gives everything static about a run (the resolved
  interval, each phase's ``CommSchedule`` summary, the analytic step times
  and the CCR left after compression) without running anything.

    import repro_torch.api as api
    result = api.fit("gpt2-paper", reduced=True, interval="auto", steps=20)
    print(result.interval, result.ccr)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import torch

from .configs import get_config, get_reduced
from .core import build_plan, get_compressor
from .core.ccr import (
    HardwareSpec,
    analytic_ccr,
    analytic_times,
    compressed_ccr,
    select_interval,
)
from .core.comm import flat_axis_index, world_size
from .core.schedule import CommSchedule, plan_all_phases
from .data import DataConfig, make_loader
from .models import build_model, count_params, param_shapes
from .optim import adamw, cosine_warmup, sgd
from .train.trainer import TrainConfig, Trainer


@dataclasses.dataclass(frozen=True)
class IntervalChoice:
    """How ``interval="auto"`` was resolved."""

    interval: int
    ccr: float | None          # None when the interval was given explicitly
    auto: bool
    dp_world: int
    grad_bytes: int
    step_flops_per_chip: float


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported; ROADMAP.md queue 1, {item!r}")


def resolve_interval(interval, cfg, *, global_batch: int, seq_len: int,
                     dp_world: int, hw: HardwareSpec | None = None
                     ) -> IntervalChoice:
    """The paper's adaptive compression ratio as a library call: with
    ``interval="auto"``, ``I = ceil(analytic_ccr)`` on the paper's
    environment (V100 + 30 Gbps Ethernet) unless ``hw`` is given; an
    integer passes through.  ``"adaptive"`` (the online re-planning
    runtime) is not ported."""
    if interval == "adaptive":
        raise _not_ported("interval='adaptive'", "CCR, perf model and adaptive runtime")
    hw = hw or HardwareSpec.cloud_v100_30gbps()
    n_active = count_params(cfg, active_only=True)
    flops = 6.0 * n_active * global_batch * seq_len / max(dp_world, 1)
    grad_bytes = count_params(cfg) * 4
    if interval != "auto":
        return IntervalChoice(int(interval), None, False, dp_world, grad_bytes, flops)
    ccr = analytic_ccr(step_flops_per_chip=flops, grad_bytes=grad_bytes,
                       dp_world=max(dp_world, 1), hw=hw)
    return IntervalChoice(select_interval(ccr), ccr, True, dp_world, grad_bytes, flops)


def _config(arch: str, *, reduced: bool, vocab_size: int | None = None):
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if vocab_size is not None:
        cfg = cfg.with_(vocab_size=vocab_size)
    return cfg


def _compressor_opts(name: str, opts: dict | None, interval: int) -> dict:
    opts = dict(opts or {})
    if name == "covap":
        opts.setdefault("interval", interval)
    return opts


def _static_setup(arch: str, *, reduced: bool, interval, seq_len: int,
                  global_batch: int, dp_workers: int, bucket_bytes: int,
                  max_buckets: int, hw: HardwareSpec):
    """The setup :func:`plan_report` needs, with nothing allocated: config,
    interval, bucket plan (from ``meta`` tensors of the parameters' shapes)
    and analytic step times."""
    cfg = _config(arch, reduced=reduced)
    choice = resolve_interval(interval, cfg, global_batch=global_batch,
                              seq_len=seq_len, dp_world=dp_workers, hw=hw)
    dtype = getattr(torch, cfg.param_dtype)
    plan = build_plan(
        [(path, torch.empty(shape, dtype=dtype, device="meta"))
         for path, shape in param_shapes(cfg).items()],
        bucket_bytes=bucket_bytes, max_buckets=max_buckets,
        interval=choice.interval,
    )
    times = analytic_times(step_flops_per_chip=choice.step_flops_per_chip,
                           grad_bytes=choice.grad_bytes,
                           dp_world=max(dp_workers, 1), hw=hw)
    return cfg, choice, plan, times


def _optimizer(name: str, lr: float, steps: int):
    if name == "adam":
        return adamw(cosine_warmup(lr, steps // 10 + 1, steps))
    if name == "sgd":
        return sgd(lr, momentum=0.9)
    raise ValueError(f"unknown optimizer {name!r}")


@dataclasses.dataclass
class FitResult:
    trainer: Trainer
    state: Any
    history: list[dict]
    interval: int
    ccr: float | None
    schedules: list[CommSchedule]

    @property
    def final_interval(self) -> int:
        """The interval the run ended with (no online re-planning is ported,
        so ``interval``)."""
        return self.trainer.tc.interval

    @property
    def final_loss(self) -> float | None:
        if not self.history:
            return None
        m = self.history[-1]
        return m.get("loss", m.get("total_loss"))


def _worker_batches(dc: DataConfig, device, group) -> Iterable[dict]:
    """The synthetic global batches, each worker's contiguous rows of each
    (the split the reference's data axis makes)."""
    loader = make_loader(dc, device=device)
    W, rank = world_size(group), flat_axis_index(group)
    if dc.global_batch % W:
        raise ValueError(f"global_batch {dc.global_batch} does not split over "
                         f"{W} workers")
    local = dc.global_batch // W
    rows = slice(rank * local, (rank + 1) * local)
    for batch in loader:
        yield {k: v[rows] for k, v in batch.items()} if W > 1 else batch


def fit(arch: str = "gpt2-paper", *, reduced: bool = True, compressor: str = "covap",
        compressor_options: dict | None = None, interval: int | str = "auto",
        steps: int = 20, seq_len: int = 32, global_batch: int = 8,
        dp_workers: int = 8, optimizer: str = "adam", lr: float = 1.5e-4,
        bucket_bytes: int = 1 << 14, max_buckets: int = 32,
        vocab_size: int | None = None, hw: HardwareSpec | None = None,
        group=None, device: str = "cuda", seed: int = 0,
        init: dict[str, torch.Tensor] | None = None, log=None, log_every: int = 10,
        batches=None, overlap: str = "post", arena: bool = False,
        sync: str = "allreduce", autotune=None, telemetry=None, guards=None,
        faults=None) -> FitResult:
    """Train ``arch`` with a compressor; ``interval="auto"`` applies the
    paper's ``I = ceil(CCR)`` from the analytic profiler.

    ``dp_workers`` is the modelled data-parallel world of the CCR on a run
    with no process group; with a ``group`` (``torch.distributed``) its
    size wins, and each worker trains on its contiguous rows of every
    global batch.  The model is built on ``device`` (the GPU unless the
    caller passes ``"cpu"``) from ``seed``, or loaded from ``init`` (a state
    dict by path, e.g. ``interop.params_from_jax``); ``batches`` replaces
    the synthetic loader.  ``overlap="fused"``, ``arena=True`` and
    ``sync="sharded"`` pick the execution forms of ``TrainConfig``.

    Not ported (they raise ``NotImplementedError``): ``interval="adaptive"``
    and ``autotune`` (the adaptive runtime), ``telemetry``, ``guards`` and
    ``faults``."""
    for value, what, item in (
            (autotune, "autotune", "CCR, perf model and adaptive runtime"),
            (telemetry, "telemetry", "Observability and resilience"),
            (guards, "guards", "Observability and resilience"),
            (faults, "faults", "Observability and resilience")):
        if value is not None:
            raise _not_ported(what, item)
    cfg = _config(arch, reduced=reduced, vocab_size=vocab_size)
    dp_world = world_size(group) if group is not None else dp_workers
    choice = resolve_interval(interval, cfg, global_batch=global_batch,
                              seq_len=seq_len, dp_world=dp_world, hw=hw)
    tc = TrainConfig(
        compressor=compressor, compressor_options=dict(compressor_options or {}),
        interval=choice.interval, bucket_bytes=bucket_bytes, max_buckets=max_buckets,
        steps=steps, log_every=log_every, overlap=overlap, arena=arena, sync=sync,
    )
    model = build_model(cfg, device=device, seed=seed)
    if init is not None:
        model.load_state_dict(init)
    tr = Trainer(model, _optimizer(optimizer, lr, steps), tc, group=group)
    state = tr.init_state()
    if batches is None:
        batches = _worker_batches(
            DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                       global_batch=global_batch), device, group)
    state = tr.run(state, iter(batches), steps=steps, log=log)
    return FitResult(trainer=tr, state=state, history=tr.history,
                     interval=choice.interval, ccr=choice.ccr,
                     schedules=tr.schedules())


def plan_report(arch: str = "gpt2-paper", *, reduced: bool = True,
                compressor: str = "covap", compressor_options: dict | None = None,
                interval: int | str = "auto", seq_len: int = 32, global_batch: int = 8,
                dp_workers: int = 8, bucket_bytes: int = 1 << 14, max_buckets: int = 32,
                hw: HardwareSpec | None = None, sync: str = "allreduce") -> dict:
    """Everything static about a run, with nothing run or allocated: the
    interval's resolution, each phase's ``CommSchedule`` summary, the
    analytic step times and the CCR left after compression.
    ``sync="sharded"`` reports each phase's exposed and deferred bytes."""
    hw = hw or HardwareSpec.cloud_v100_30gbps()
    cfg, choice, plan, times = _static_setup(
        arch, reduced=reduced, interval=interval, seq_len=seq_len,
        global_batch=global_batch, dp_workers=dp_workers,
        bucket_bytes=bucket_bytes, max_buckets=max_buckets, hw=hw,
    )
    opts = _compressor_opts(compressor, compressor_options, choice.interval)
    if sync != "allreduce":
        opts.setdefault("sync", sync)
    schedules = plan_all_phases(get_compressor(compressor, **opts), plan,
                                world=dp_workers)
    return {
        "arch": cfg.name,
        "compressor": compressor,
        "interval": choice.interval,
        "interval_auto": choice.auto,
        "analytic_ccr": choice.ccr if choice.auto else times["ccr"],
        "dense_ccr": times["ccr"],
        "residual_ccr": compressed_ccr(schedules, t_comp=times["t_comp"],
                                       world=dp_workers, hw=hw, link_bw=hw.ici_bw),
        "t_before": times["t_before"],
        "t_comp": times["t_comp"],
        "t_comm_dense": times["t_comm"],
        "num_buckets": plan.num_buckets,
        "phases": [s.summary() for s in schedules],
    }


__all__ = ["FitResult", "IntervalChoice", "fit", "plan_report", "resolve_interval"]
