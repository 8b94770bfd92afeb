"""Sparsification baselines: Top-k (Aji & Heafield), Random-k (Stich et
al.) and DGC (Lin et al.).

Each is ``SyncPipeline(ef=ErrorFeedback(), wire=<stage>)`` on the flat-bucket
path, with a per-bucket wire stage from :mod:`repro_torch.core.stages`, the
classic EF rule (residual accumulation, coefficient 1), and the collective
pattern of their reference implementations:

* Top-k / DGC: each worker's indices differ, so the exchange is an
  all-gather of (values, int32 indices).  ``torch.topk`` selects exactly k.
* Random-k: the index set comes from the bucket's ``BucketKey`` of
  ``(seed, step, bucket)``, the same on every worker, so the exchange is a
  dense all-reduce of the selected values only, with no index traffic.

None of them runs a kernel of its own, and none takes the fused overlap or
sharded sync: their wire sees each bucket whole, after EF has compensated
the whole tree.
"""
from __future__ import annotations

from .. import stages
from ..stages import ErrorFeedback, SyncPipeline
from .base import register


@register("topk")
class TopK(SyncPipeline):
    """Aji & Heafield sparse communication: the largest-|g| ``ratio`` of
    each bucket."""

    def __init__(self, ratio: float = 0.01, seed: int = 0, ef: bool = True,
                 **opts):
        super().__init__(
            wire=stages.TopK(ratio),
            ef=ErrorFeedback() if ef else None,
            seed=seed,
            ratio=ratio,
            **opts,
        )
        self.ratio = float(ratio)
        self.use_ef = ef


@register("dgc")
class DGC(SyncPipeline):
    """Deep Gradient Compression: an aggressive ratio (0.1%) and local
    gradient clipping before selection (momentum correction folded into
    EF); the clipped mass lands in the residual, ``t - sent``."""

    def __init__(self, ratio: float = 0.001, clip_norm: float = 1.0, seed: int = 0,
                 **opts):
        super().__init__(
            wire=stages.TopK(ratio, clip_norm=clip_norm),
            ef=ErrorFeedback(),
            seed=seed,
            ratio=ratio,
            clip_norm=clip_norm,
            **opts,
        )
        self.ratio = float(ratio)
        self.clip_norm = float(clip_norm)
        self.use_ef = True


@register("randomk")
class RandomK(SyncPipeline):
    """Stich et al. sparsified SGD: k uniformly random coordinates from a
    key every worker shares, and a dense all-reduce of their values."""

    def __init__(self, ratio: float = 0.01, seed: int = 0, ef: bool = True,
                 **opts):
        super().__init__(
            wire=stages.RandomK(ratio),
            ef=ErrorFeedback() if ef else None,
            seed=seed,
            ratio=ratio,
            **opts,
        )
        self.ratio = float(ratio)
        self.use_ef = ef
