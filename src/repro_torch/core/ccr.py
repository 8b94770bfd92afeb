"""CCR (communication-to-computation ratio) estimation and interval
selection (paper SS III.B), the counterpart of ``repro.core.ccr``.

Two estimators:

* ``analytic_ccr`` takes the communication volume and the FLOPs of a step
  from the configuration, before anything runs;
* ``measure_ccr`` / ``align_comm_times`` are the paper's measured
  profiler: a full step timed against a communication-free one, and the
  distributed timeline alignment, under which a collective's transfer
  starts when the *last* worker arrives (``end - max_w(start_w)``).  The
  adaptive runtime (``runtime.monitor.PhaseProbe``) consumes it.

The adaptive rule is the paper's: ``I = ceil(CCR)``, a little more
compression than strictly needed, so that the remaining communication fits
under the backward pass.

:class:`HardwareSpec` carries no accelerator default: the paper's
environment (V100 + 30 Gbps Ethernet, :meth:`HardwareSpec.cloud_v100_30gbps`)
is the port's named spec and the fallback wherever the caller passes none.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-device rates of the analytic model.

    ``peak_flops`` (FLOP/s at the compute dtype), ``hbm_bw`` (device memory,
    bytes/s), ``ici_bw`` (bytes/s of the link the data-parallel collectives
    cross, the reference's name for it; NVLink inside a node), ``mfu`` (the
    model-FLOPs utilisation assumed) and ``dcn_bw`` (bytes/s per device
    across pods, the network between nodes; ``None``: the same as
    ``ici_bw``)."""

    peak_flops: float
    hbm_bw: float
    ici_bw: float
    mfu: float
    dcn_bw: float | None = None

    def __post_init__(self):
        if self.dcn_bw is None:
            object.__setattr__(self, "dcn_bw", self.ici_bw)

    @staticmethod
    def cloud_v100_30gbps() -> "HardwareSpec":
        """The paper's environment: V100 + 30 Gbps Ethernet, between the
        nodes too (``dcn_bw == ici_bw``)."""
        return HardwareSpec(peak_flops=125e12, hbm_bw=900e9, ici_bw=30e9 / 8,
                            mfu=0.35, dcn_bw=30e9 / 8)

    @staticmethod
    def h100_sxm() -> "HardwareSpec":
        """One NVIDIA H100 SXM5 in a DGX H100, the card the port runs on,
        from NVIDIA's H100 SXM5 data sheet: 989.4 TFLOP/s of dense bf16,
        3.35 TB/s of HBM3, NVLink 4 at 450 GB/s a direction inside the node
        (``ici_bw``), and the DGX H100 compute fabric's one 400 Gb/s NIC a
        GPU between nodes (``dcn_bw``, 50 GB/s).  ``mfu`` is the
        reference's default, 0.4 (the counterpart of its
        ``HardwareSpec.v5e()``)."""
        return HardwareSpec(peak_flops=989.4e12, hbm_bw=3.35e12, ici_bw=450e9,
                            mfu=0.4, dcn_bw=400e9 / 8)


def allreduce_bytes_on_wire(payload_bytes: float, world: int) -> float:
    """Ring all-reduce: each worker moves ``2 (W-1)/W`` of the payload."""
    if world <= 1:
        return 0.0
    return 2.0 * (world - 1) / world * payload_bytes


def analytic_times(*, step_flops_per_chip: float, grad_bytes: float, dp_world: int,
                   hw: HardwareSpec, fwd_fraction: float = 1.0 / 3.0) -> dict:
    """Analytic ``T_before`` / ``T_comp`` / ``T_comm`` of one DP step (paper
    Table I): ``step_flops_per_chip`` is the forward + backward model FLOPs a
    device runs; the forward pass (``T_before``) takes ``fwd_fraction`` of
    the compute, the backward pass (``T_comp``) the rest."""
    t_total_compute = step_flops_per_chip / (hw.peak_flops * hw.mfu)
    t_before = t_total_compute * fwd_fraction
    t_comp = t_total_compute * (1.0 - fwd_fraction)
    t_comm = allreduce_bytes_on_wire(grad_bytes, dp_world) / hw.ici_bw
    return {"t_before": t_before, "t_comp": t_comp, "t_comm": t_comm,
            "ccr": t_comm / max(t_comp, 1e-12)}


def analytic_ccr(*, step_flops_per_chip: float, grad_bytes: float, dp_world: int,
                 hw: HardwareSpec | None = None, fwd_fraction: float = 1.0 / 3.0
                 ) -> float:
    """The analytic profiler's CCR; ``interval="auto"`` is ``I =
    ceil(analytic_ccr(...))``.  ``hw`` defaults to the paper's environment."""
    return analytic_times(
        step_flops_per_chip=step_flops_per_chip, grad_bytes=grad_bytes,
        dp_world=dp_world, hw=hw or HardwareSpec.cloud_v100_30gbps(),
        fwd_fraction=fwd_fraction,
    )["ccr"]


def select_interval(ccr: float, max_interval: int = 64) -> int:
    """The paper's adaptive compression ratio: ``I = ceil(CCR)``, at least 1
    and at most ``max_interval``."""
    return int(min(max(1, math.ceil(ccr)), max_interval))


def schedule_comm_seconds(schedules: Sequence, *, world: int,
                          hw: HardwareSpec | None = None,
                          link_bw: float | None = None) -> float:
    """Mean communication seconds a step over a compressor's phase cycle,
    from its static ``CommSchedule``s: the executed-volume counterpart of
    :func:`analytic_times`'s dense estimate."""
    hw = hw or HardwareSpec.cloud_v100_30gbps()
    bw = link_bw or hw.ici_bw
    schedules = tuple(schedules)
    if not schedules:
        return 0.0
    return sum(s.wire_bytes(world) for s in schedules) / len(schedules) / bw


def compressed_ccr(schedules: Sequence, *, t_comp: float, world: int,
                   hw: HardwareSpec | None = None,
                   link_bw: float | None = None) -> float:
    """The CCR left after compression: planned wire seconds over backward
    seconds.  COVAP aims below 1, communication hidden entirely."""
    t_comm = schedule_comm_seconds(schedules, world=world, hw=hw, link_bw=link_bw)
    return t_comm / max(t_comp, 1e-12)


def align_comm_times(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Distributed-profiler alignment (paper SS III.B, Fig. 3).

    ``starts`` / ``ends``: ``(workers, ops)`` wall-clock times of each
    collective.  Returns the ``(ops,)`` transfer times ``min_w(end) -
    max_w(start)``: the time early workers spend waiting at the rendezvous
    is excluded."""
    starts = np.asarray(starts, dtype=np.float64)
    ends = np.asarray(ends, dtype=np.float64)
    return ends.min(axis=0) - starts.max(axis=0)


def measure_ccr(step_full: Callable[[], None], step_compute_only: Callable[[], None],
                *, step_comm_only: Callable[[], None] | None = None,
                warmup: int = 2, iters: int = 5) -> dict:
    """Measured profiler: times a full data-parallel step against a
    communication-free one and derives ``CCR = (T_full - T_comp) / T_comp``.

    Each callable must return only once its work is done (on the GPU, after
    a device synchronisation): the clock is the host's ``time.perf_counter``
    around ``iters`` calls after ``warmup`` untimed ones, so the step's host
    time counts as the user pays for it.  ``step_comm_only`` (the phase's
    planned collectives on zero buffers) adds a ``t_comm_direct``
    cross-check: under full overlap ``t_full - t_comp`` undershoots the wire
    time, so the reported ``t_comm`` is the larger of the two."""

    def timed(fn):
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters

    t_full = timed(step_full)
    t_comp = timed(step_compute_only)
    t_comm = max(t_full - t_comp, 0.0)
    out = {"t_full": t_full, "t_comp": t_comp}
    if step_comm_only is not None:
        t_direct = timed(step_comm_only)
        out["t_comm_direct"] = t_direct
        t_comm = max(t_comm, t_direct)
    out["t_comm"] = t_comm
    out["ccr"] = t_comm / max(t_comp, 1e-12)
    return out


__all__ = [
    "HardwareSpec",
    "align_comm_times",
    "allreduce_bytes_on_wire",
    "analytic_ccr",
    "analytic_times",
    "compressed_ccr",
    "measure_ccr",
    "schedule_comm_seconds",
    "select_interval",
]
