"""Resilience (the counterpart of ``repro.resilience``): deterministic fault
injection, cheap numeric guardrails and the skip-step -> EF-flush ->
checkpoint-rewind recovery ladder, wired through ``Trainer.run(guards=...,
faults=...)``, ``api.fit`` and the CLI.

Production::

    from repro_torch.resilience import GuardConfig
    tr.run(state, batches, guards=GuardConfig(ckpt_dir="ckpt", ckpt_every=50))

Chaos (the same plan and seed corrupt the same elements)::

    tr.run(state, batches, guards=True, faults="grad_nan@10,ef_blowup@20")
"""
from .faults import (
    FAULT_KINDS,
    GRAD_FAULTS,
    FaultEvent,
    FaultInjector,
    FaultPlan,
    InjectedCrash,
    as_fault_plan,
    blowup_residual,
    corrupt_planes,
    corrupt_tree,
    parse_fault_spec,
    release_pages,
    starve_pages,
)
from .guards import (
    GUARD_KINDS,
    GuardConfig,
    Guards,
    GuardTrip,
    as_guard_config,
    plane_nonfinite_counts,
)
from .recovery import ACTIONS, RecoveryError, ResilienceRuntime

__all__ = [
    "ACTIONS",
    "FAULT_KINDS",
    "FaultEvent",
    "FaultInjector",
    "FaultPlan",
    "GRAD_FAULTS",
    "GUARD_KINDS",
    "GuardConfig",
    "GuardTrip",
    "Guards",
    "InjectedCrash",
    "RecoveryError",
    "ResilienceRuntime",
    "as_fault_plan",
    "as_guard_config",
    "blowup_residual",
    "corrupt_planes",
    "corrupt_tree",
    "parse_fault_spec",
    "plane_nonfinite_counts",
    "release_pages",
    "starve_pages",
]
