"""The port's library surface: ``repro_torch.api.fit``, ``plan_report``
and ``tune`` (the counterpart of ``repro.api``).

* :func:`fit` trains an architecture with a registered compressor.
  ``interval="auto"`` resolves the paper's adaptive rule ``I =
  ceil(analytic_ccr)`` (SS III.B) before the first step;
  ``interval="adaptive"`` starts there and re-plans online from the
  measured CCR (``runtime``).
* :func:`plan_report` gives everything static about a run (the resolved
  interval, each phase's ``CommSchedule`` summary, the analytic step times
  and the CCR left after compression) without running anything.
* :func:`tune` ranks candidate compressors for a workload by the
  schedule-driven overlap timeline (eq (6) with real planned volumes).

    import repro_torch.api as api
    result = api.fit("gpt2-paper", reduced=True, interval="auto", steps=20)
    print(result.interval, result.ccr)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

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
from .core.perfmodel import (
    cycle_speedup,
    overlap_fraction,
    pack_overhead_s,
    simulate_schedule,
)
from .core.schedule import CommSchedule, mean_bytes_per_step, plan_all_phases
from .data import DataConfig, make_loader
from .models import build_model, count_params
from .obs import as_telemetry
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


def resolve_interval(interval, cfg, *, global_batch: int, seq_len: int,
                     dp_world: int, hw: HardwareSpec | None = None
                     ) -> IntervalChoice:
    """The paper's adaptive compression ratio as a library call: with
    ``interval="auto"``, ``I = ceil(analytic_ccr)`` on the paper's
    environment (V100 + 30 Gbps Ethernet) unless ``hw`` is given; an
    integer passes through.  ``interval="adaptive"`` resolves the same way:
    the analytic pick is the *initial* interval, which the online runtime
    then re-plans from the measured CCR."""
    hw = hw or HardwareSpec.cloud_v100_30gbps()
    n_active = count_params(cfg, active_only=True)
    flops = 6.0 * n_active * global_batch * seq_len / max(dp_world, 1)
    grad_bytes = count_params(cfg) * 4
    if interval not in ("auto", "adaptive"):
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
    plan = build_plan(
        build_model(cfg, device="meta").named_leaves(),
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
    autotune: dict | None = None   # the AdaptiveRuntime's summary (adaptive mode)
    telemetry: Any = None          # the repro_torch.obs.Telemetry when armed
    resilience: dict | None = None  # the ResilienceRuntime's summary (guards mode)

    @property
    def final_interval(self) -> int:
        """The interval after any online re-planning (``interval`` when the
        run was static)."""
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

    ``interval="adaptive"`` starts from the analytic pick and arms the
    adaptive runtime (``repro_torch.runtime``): the measured CCR re-plans
    the interval online, the EF residuals carried across each switch.
    ``autotune`` passes an ``AutotuneConfig`` (or True) to tune the policy;
    it may also be given with a numeric ``interval``.  ``telemetry`` (None
    | directory path | ``repro_torch.obs.Telemetry``) records the run; the
    bundle comes back as ``FitResult.telemetry``.  ``guards`` and ``faults``
    arm the resilience runtime (``Trainer.run``'s arguments); its summary
    (trips, actions by rung, faults fired) comes back as
    ``FitResult.resilience``.  The run returns when ``steps`` steps are
    committed (``state["step"] == steps``), replays after a recovery
    included; the reference returns after ``steps`` executions, which can
    leave the state behind."""
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
    if interval == "adaptive" and autotune is None:
        autotune = True
    tel = as_telemetry(telemetry)
    it = iter(batches)
    state = tr.run(state, it, steps=steps, log=log, autotune=autotune,
                   telemetry=tel, guards=guards, faults=faults)
    # a recovery can set the state back: run on, with the same runtimes,
    # until ``steps`` steps are committed
    while state["step"] < steps:
        state = tr.run(state, it, steps=steps - state["step"], log=log,
                       autotune=tr.runtime, telemetry=tel, guards=tr.resilience)
    return FitResult(trainer=tr, state=state, history=tr.history,
                     interval=choice.interval, ccr=choice.ccr,
                     schedules=tr.schedules(),
                     autotune=tr.runtime.summary() if tr.runtime is not None else None,
                     telemetry=tel if tel.enabled else None,
                     resilience=(tr.resilience.summary() if tr.resilience is not None
                                 else None))


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


_TUNE_CANDIDATES = (
    ("covap", {}),
    ("none", {}),
    ("fp16", {}),
    ("topk", {"ratio": 0.01}),
    ("randomk", {"ratio": 0.01}),
    ("efsignsgd", {}),
    ("powersgd", {"rank": 2}),
    ("oktopk", {"ratio": 0.01}),
    ("fp8wire", {}),
)


def tune(arch: str = "gpt2-paper", *, reduced: bool = True,
         candidates: Sequence[tuple[str, dict]] = _TUNE_CANDIDATES,
         interval: int | str = "auto", seq_len: int = 32, global_batch: int = 8,
         dp_workers: int = 8, bucket_bytes: int = 1 << 14, max_buckets: int = 32,
         hw: HardwareSpec | None = None, measured: bool = False,
         measure_steps: int = 2, arena: bool = False, telemetry=None,
         device: str = "cuda") -> list[dict]:
    """Rank compressors for a workload by the schedule-driven overlap
    timeline (eq (6) with each one's planned volumes), best modelled
    speedup first.  Data-dependent exchanges (all-to-all) lose their
    overlap, as in the paper's Fig. 1(e).  The analytic columns are priced
    on ``hw``, by default the paper's environment (V100 + 30 Gbps
    Ethernet), whatever device runs the program.

    ``arena=True`` puts the arena's pack pass (``perfmodel.pack_overhead_s``)
    on the timeline's compute lane, as ``fit(arena=True)`` runs it; the
    ``pack_overhead_us`` column is there either way.

    ``measured=True`` also runs the online profiler
    (``runtime.measure_workload_ccr``) on the dense workload on ``device``
    (the GPU unless the caller passes ``"cpu"``): ``measure_steps`` real
    steps, then one probe of the phase.  Every row then carries the
    measured CCR, the interval it implies and the achieved overlap.  On one
    worker the measured comm time is about 0.  ``telemetry`` gets one
    ``tune_row`` event and two gauges a row."""
    hw = hw or HardwareSpec.cloud_v100_30gbps()
    cfg, choice, plan, times = _static_setup(
        arch, reduced=reduced, interval=interval, seq_len=seq_len,
        global_batch=global_batch, dp_workers=dp_workers,
        bucket_bytes=bucket_bytes, max_buckets=max_buckets, hw=hw,
    )
    measured_row = None
    if measured:
        measured_row = _measured_workload_ccr(
            cfg, seq_len=seq_len, global_batch=global_batch,
            bucket_bytes=bucket_bytes, max_buckets=max_buckets,
            steps=measure_steps, device=device,
        )
    rows = []
    for name, opts in candidates:
        opts = _compressor_opts(name, opts, choice.interval)
        comp = get_compressor(name, **opts)
        schedules = plan_all_phases(comp, plan, world=dp_workers)
        data_dep = any(c.op == "all_to_all" for s in schedules for c in s.calls)
        speedup = cycle_speedup(
            dp_workers, times["t_before"], times["t_comp"], schedules,
            world=dp_workers, link_bw=hw.ici_bw, data_dependency=data_dep,
        )
        mean_bytes = mean_bytes_per_step(schedules)
        # the arena's pack pass, one streaming sweep of device memory a
        # phase: priced into the timeline below and kept as its own column
        ef_on = getattr(comp, "ef", None) is not None
        packs = [pack_overhead_s(s, hbm_bw=hw.hbm_bw, ef=ef_on) for s in schedules]
        pack_us = sum(packs) / max(len(packs), 1) * 1e6
        # the predicted overlap fraction: the eq-(6) timeline in the fused
        # overlap's issue order (ReadyOrder)
        sims = [
            simulate_schedule(
                times["t_before"], times["t_comp"], s,
                world=dp_workers, link_bw=hw.ici_bw,
                t_pack=t_pack if arena else 0.0,
                data_dependency=data_dep, ready_order=True,
            )
            for s, t_pack in zip(schedules, packs)
        ]
        predicted_overlap = sum(overlap_fraction(s) for s in sims) / max(len(sims), 1)
        row = {
            "compressor": name,
            "options": opts,
            "speedup": speedup,
            "efficiency": speedup / max(dp_workers, 1),
            "mean_bytes_per_step": mean_bytes,
            "volume_ratio": schedules[0].dense_bytes / max(mean_bytes, 1),
            "data_dependency": data_dep,
            "num_phases": len(schedules),
            "analytic_ccr": times["ccr"],
            "overlap_frac_modeled": predicted_overlap,
            "pack_overhead_us": pack_us,
        }
        if measured_row is not None:
            row["measured_ccr"] = measured_row["ccr"]
            row["measured_interval"] = measured_row["interval"]
            # what the executed dense step hid, beside the model's prediction
            row["overlap_frac_achieved"] = measured_row.get("achieved_overlap")
        rows.append(row)
    rows.sort(key=lambda r: -r["speedup"])
    tel = as_telemetry(telemetry)
    if tel.enabled:
        for row in rows:
            tel.events.emit("tune_row", compressor=row["compressor"], row=row)
            tel.registry.gauge("tune_speedup", "modeled cycle speedup",
                               compressor=row["compressor"]).set(row["speedup"])
            tel.registry.gauge(
                "tune_overlap_frac_modeled", "predicted overlap fraction",
                compressor=row["compressor"],
            ).set(row["overlap_frac_modeled"])
    return rows


def _measured_workload_ccr(cfg, *, seq_len: int, global_batch: int, bucket_bytes: int,
                           max_buckets: int, steps: int, device: str) -> dict:
    """A few real dense steps on ``device`` through the measured profiler:
    what the hardware delivers for this workload, as a CCR and an
    interval."""
    from .runtime import measure_workload_ccr

    model = build_model(cfg, device=device, seed=0)
    tc = TrainConfig(compressor="none", interval=1, bucket_bytes=bucket_bytes,
                     max_buckets=max_buckets, log_every=10 ** 9)
    tr = Trainer(model, sgd(1e-3), tc)
    state = tr.init_state()
    batch = next(iter(make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                             global_batch=global_batch), device=device)))
    state = tr.run(state, iter([batch] * max(steps, 1)), steps=max(steps, 1), log=None)
    out = measure_workload_ccr(tr, state, batch)
    out["interval"] = select_interval(out["ccr"])
    return out


__all__ = ["FitResult", "IntervalChoice", "fit", "plan_report", "resolve_interval",
           "tune"]
