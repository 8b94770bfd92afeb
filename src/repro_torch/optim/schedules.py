"""Learning-rate schedules: ``step -> lr`` as a ``numpy.float32`` computed
on the host, with the reference's float32 arithmetic."""
from __future__ import annotations

import numpy as np

f32 = np.float32


def constant(lr: float):
    return lambda step: f32(lr)


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        return f32(f32(lr) * min(f32(1.0), f32(step) / f32(max(warmup_steps, 1))))

    return fn


def cosine_warmup(lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def fn(step):
        s = f32(step)
        warm = min(f32(1.0), s / f32(max(warmup_steps, 1)))
        frac = np.clip(
            (s - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
            f32(0.0), f32(1.0),
        )
        cos = f32(min_ratio) + f32(1 - min_ratio) * f32(0.5) * (
            f32(1) + np.cos(f32(np.pi) * frac)
        )
        return f32(f32(lr) * warm * cos)

    return fn
