"""COVAP: the paper's contribution (SS III.A-D), as a stage composition.

COVAP is ``CoarseFilter(I) ∘ ErrorFeedback(EFSchedule) ∘ WireCast`` under
:class:`~repro_torch.core.stages.SyncPipeline`.  Per step with phase
``p = step % I``:

  1. ``t = g + coeff(step) * residual``           (error feedback, SS III.D)
  2. buckets with ``(b + p) % I == 0`` are all-reduced segment by segment;
     everything else is not communicated at all
  3. ``residual' = t`` at unselected positions, ``0`` at selected ones

Steps 1 and 3 run as one pass of a CUDA kernel per segment on the GPU:
``ef_update`` on the per-segment path, ``pack_ef_cast`` (which also writes
the wire values into the arena slot, cast when ``wire_dtype`` is set) on
the arena and sharded paths.
"""
from __future__ import annotations

from ..error_feedback import EFSchedule
from ..stages import CoarseFilter, ErrorFeedback, SyncPipeline, WireCast
from .base import register


@register("covap")
class COVAP(SyncPipeline):
    def __init__(
        self,
        interval: int = 4,
        ef: bool = True,
        ef_init: float = 0.3,
        ef_ascend_steps: int = 200,
        ef_ascend_range: float = 0.1,
        wire_dtype: str = "",
        use_ef_kernel: bool | None = None,
        **opts,
    ):
        """``wire_dtype='bfloat16'`` (or ``'float16'``) also casts the
        selected buckets on the wire, halving their bytes; the cast's error
        lands in the EF residual.

        ``use_ef_kernel``: ``None`` (default) runs the CUDA EF kernel on
        CUDA tensors and the plain two-op form on CPU tensors; ``False``
        keeps the two-op form on the GPU too.  ``use_pack_kernel`` does the
        same for the ``pack_ef_cast`` kernel of the arena and sharded
        paths."""
        if interval == "auto":
            raise NotImplementedError(
                "interval='auto' needs the analytic CCR, which is not ported; "
                "pass an integer interval"
            )
        interval = int(interval)
        schedule = EFSchedule(ef_init, ef_ascend_steps, ef_ascend_range)
        filtered = interval > 1
        super().__init__(
            wire=WireCast(wire_dtype or None),
            filter=CoarseFilter(interval) if filtered else None,
            ef=ErrorFeedback(schedule) if (ef and filtered) else None,
            interval=interval,
            use_ef_kernel=use_ef_kernel,
            **opts,
        )
