from .trainer import (
    TrainConfig,
    Trainer,
    build_overlapped_step,
    build_step_fn,
    loss_and_grads,
    make_compressor,
    make_train_state,
)

__all__ = [
    "TrainConfig",
    "Trainer",
    "build_overlapped_step",
    "build_step_fn",
    "loss_and_grads",
    "make_compressor",
    "make_train_state",
]
