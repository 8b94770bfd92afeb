"""Beyond-paper compressor: block-scaled FP8 gradient exchange.

``SyncPipeline(ef=ErrorFeedback(), wire=FP8Block(block))``: 4x wire
compression against float32, with one amax scale per ``block`` (8192)
elements.  Workers' payloads differ, so the exchange is an all-gather of
(fp8 payload, float32 scales), decoded as the mean of the dequantised
contributions; with error feedback the quantisation error stays in the
residual.  On CUDA tensors the encode and decode are the ``quantize_fp8``
and ``dequantize_fp8`` kernels (``kernels/csrc/quantize_fp8.cu``).
"""
from __future__ import annotations

from ..stages import ErrorFeedback, FP8Block, SyncPipeline
from .base import register


@register("fp8wire")
class FP8Wire(SyncPipeline):
    def __init__(self, block: int = 8192, seed: int = 0, ef: bool = True,
                 **opts):
        """``use_wire_kernel``: ``None`` (default) runs the CUDA kernels on
        CUDA tensors and the plain versions on CPU tensors; ``False`` keeps
        the plain versions on the GPU too.  ``seed`` is kept for the
        reference's signature; the FP8 wire draws no random numbers."""
        super().__init__(
            wire=FP8Block(block),
            ef=ErrorFeedback() if ef else None,
            seed=seed,
            block=block,
            **opts,
        )
        self.block = int(block)
        self.use_ef = ef
