"""Chunked whole-prompt prefill — the counterpart of
``repro.serve.prefill``.

The reference compiles a ``lax.scan`` of ``decode_step`` over a chunk of
prompt tokens: one compiled call per ``chunk_tokens``.  Here a chunk is a
loop of the same ``decode_step`` at batch 1, one token at a time, so the
cache fills exactly as sequential decode fills it, and continuous batching
stays checkable token for token against one-at-a-time decode.  The chunk
is kept as the unit of counting (``n_calls = ceil(L / chunk)``), and the
chunk size does not change the output.

The prompt goes to the device in one transfer; each token's position is
made on the device, so the loop reads nothing back until the caller
samples the last logits.
"""
from __future__ import annotations

import torch


class ChunkedPrefill:
    """Callable prefill stage.  ``__call__`` consumes the whole prompt and
    returns the last-token logits (which predict the first generated
    token), the filled batch-1 cache, and the number of chunk calls it
    made."""

    def __init__(self, model, chunk_tokens: int = 16):
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
        self.model = model
        self.chunk_tokens = int(chunk_tokens)

    def _chunk(self, params, caches, tokens: torch.Tensor, pos0: int):
        """Decode ``tokens`` (n,) at positions ``pos0 ..``; the last
        step's logits and the caches."""
        positions = torch.arange(pos0, pos0 + tokens.shape[0], device=tokens.device)
        logits = None
        for t in range(tokens.shape[0]):
            logits, caches = self.model.decode_step(
                params, caches,
                {"tokens": tokens[t:t + 1].view(1, 1), "pos": positions[t:t + 1]})
        return logits, caches

    @torch.inference_mode()
    def __call__(self, params, caches, prompt: list[int]):
        """Prefill ``prompt`` (positions 0..L-1) into ``caches`` (batch 1,
        written in place).  Returns (last_logits, caches, n_calls)."""
        device = next(self.model.parameters()).device
        toks = torch.tensor(prompt, dtype=torch.long).to(device)
        logits = None
        calls = 0
        for off in range(0, len(prompt), self.chunk_tokens):
            logits, caches = self._chunk(params, caches,
                                         toks[off:off + self.chunk_tokens], off)
            calls += 1
        return logits, caches, calls


__all__ = ["ChunkedPrefill"]
