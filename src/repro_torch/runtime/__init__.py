"""The adaptive runtime, the layer between planning and execution (the
counterpart of ``repro.runtime``).  It closes the loop that the paper's
adaptive compression needs:

    monitor  (measured CCR: ring buffers and sub-program probes)
      -> controller  (hysteresis re-planning: I = ceil(measured CCR))
        -> transitions  (EF residuals carried across plan switches)
          -> trace  (planned-vs-measured Chrome-trace timelines)

Entry points: ``Trainer.run(..., autotune=AutotuneConfig())`` and
``repro_torch.api.fit(..., interval="adaptive")``.
"""
from .controller import (
    AdaptiveRuntime,
    AutotuneConfig,
    ReplanController,
    ReplanDecision,
    as_autotune_config,
    exposed_comm_scale,
)
from .monitor import (
    CCRMonitor,
    PhaseProbe,
    PhaseSample,
    build_schedule_only_fn,
    measure_workload_ccr,
    synthetic_probe,
)
from .trace import TimelineTracer
from .transitions import TransitionReport, carry_comp_state, residual_norm

__all__ = [
    "AdaptiveRuntime",
    "AutotuneConfig",
    "CCRMonitor",
    "PhaseProbe",
    "PhaseSample",
    "ReplanController",
    "ReplanDecision",
    "TimelineTracer",
    "TransitionReport",
    "as_autotune_config",
    "build_schedule_only_fn",
    "carry_comp_state",
    "exposed_comm_scale",
    "measure_workload_ccr",
    "residual_norm",
    "synthetic_probe",
]
