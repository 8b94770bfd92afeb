"""Optimizers, LR schedules and global-norm clipping over tensor lists."""
from .clip import clip_by_global_norm, global_norm
from .optimizers import Optimizer, adamw, apply_updates, sgd
from .schedules import constant, cosine_warmup, linear_warmup

__all__ = [
    "Optimizer",
    "adamw",
    "sgd",
    "apply_updates",
    "constant",
    "cosine_warmup",
    "linear_warmup",
    "clip_by_global_norm",
    "global_norm",
]
