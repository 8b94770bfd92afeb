from .trainer import (
    TrainConfig,
    Trainer,
    build_overlapped_step,
    build_step_fn,
    hierarchical_schedules,
    loss_and_grads,
    make_compressor,
    make_train_state,
    plan_pod_schedule,
    pod_reconcile,
)

__all__ = [
    "TrainConfig",
    "Trainer",
    "build_overlapped_step",
    "build_step_fn",
    "hierarchical_schedules",
    "loss_and_grads",
    "make_compressor",
    "make_train_state",
    "plan_pod_schedule",
    "pod_reconcile",
]
