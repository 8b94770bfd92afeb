"""Ok-topk (Li & Hoefler): a near-optimal sparse all-reduce, simplified as
in the reference.

``SyncPipeline(ef=ErrorFeedback(), wire=OkTopKRoute(ratio))``.  The index
space is split into one region per worker; each worker (1) selects its
local top-k, (2) routes the entries to their region's owner by an
all-to-all with a fixed capacity, (3) the owner sums them and keeps the
regional top-(k/W), and (4) the survivors are all-gathered.  Traffic is
O(k) instead of Top-k's O(k * W), but the exchange is synchronous and
multi-stage: the data dependency the paper (SS I, Fig. 1e) names as
hostile to overlapping.

The reference's simplifications hold here too: a fixed all-to-all capacity
of 2k/W + 1 with the smallest-magnitude overflow dropped, and EF counts an
entry as sent once routed (drops at the region owner land in the error,
not the residual).  The plan counts the routing mask at the bucket's dtype,
as the reference's does.
"""
from __future__ import annotations

from ..stages import ErrorFeedback, OkTopKRoute, SyncPipeline
from .base import register


@register("oktopk")
class OkTopK(SyncPipeline):
    def __init__(self, ratio: float = 0.01, seed: int = 0, ef: bool = True,
                 **opts):
        super().__init__(
            wire=OkTopKRoute(ratio),
            ef=ErrorFeedback() if ef else None,
            seed=seed,
            ratio=ratio,
            **opts,
        )
        self.ratio = float(ratio)
        self.use_ef = ef
