"""EFsignSGD (Karimireddy et al.): sign compression with error feedback.

``SyncPipeline(ef=ErrorFeedback(), wire=SignCompress())``.  Wire format per
bucket: int8 signs (1 byte an element, 4x against float32) and one float32
scale ``mean(|t|)``.  Workers' signs differ, so the exchange is an
all-gather, which scales worse with W than an all-reduce (the paper's
Fig. 11).  Decode: ``mean_w(scale_w * sign_w)``.  On CUDA tensors the
encode is the ``sign_compress`` kernel (``kernels/csrc/sign_compress.cu``).
"""
from __future__ import annotations

from ..stages import ErrorFeedback, SignCompress, SyncPipeline
from .base import register


@register("efsignsgd")
class EFSignSGD(SyncPipeline):
    def __init__(self, seed: int = 0, ef: bool = True, **opts):
        """``use_wire_kernel`` as for ``fp8wire``; ``seed`` is kept for the
        reference's signature."""
        super().__init__(
            wire=SignCompress(),
            ef=ErrorFeedback() if ef else None,
            seed=seed,
            **opts,
        )
        self.use_ef = ef
