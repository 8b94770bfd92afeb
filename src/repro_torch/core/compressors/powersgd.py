"""PowerSGD (Vogels et al.): rank-r low-rank gradient compression.

``SyncPipeline(ef=ErrorFeedback(), wire=LowRank(rank))``, the one
leaf-granularity pipeline.  Per leaf of two or more dimensions (batched
over its leading stack axes):

    M  = t reshaped to (B, a, b)
    P  = M @ Q        ; all-reduce(P) ; P <- orthonormalize(P)   (QR)
    Q' = M^T @ P      ; all-reduce(Q')
    t~ = P @ Q'^T     ; residual = t - t~

The state carries Q from step to step (a warm start: the power
iteration).  Smaller leaves (norm scales) are all-reduced densely.  Per
matrix ``(a + b) * r`` words cross the wire instead of ``a * b``.  On CUDA
tensors the three products run the ``lowrank.matmul`` kernel
(``kernels/csrc/lowrank_matmul.cu``); the QR is ``torch.linalg.qr``.
"""
from __future__ import annotations

from ..stages import ErrorFeedback, LowRank, SyncPipeline
from .base import register


@register("powersgd")
class PowerSGD(SyncPipeline):
    def __init__(self, rank: int = 2, seed: int = 0, ef: bool = True, **opts):
        """``use_wire_kernel``: ``None`` (default) runs the matmul kernel on
        CUDA tensors and ``torch.matmul`` on CPU tensors; ``False`` keeps
        ``torch.matmul`` on the GPU too."""
        super().__init__(
            wire=LowRank(rank, seed=seed),
            ef=ErrorFeedback() if ef else None,
            seed=seed,
            rank=rank,
            **opts,
        )
        self.rank = int(rank)
        self.use_ef = bool(ef)
