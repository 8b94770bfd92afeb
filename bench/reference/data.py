"""The training batches, worked out again from the seed: a frozen NumPy copy
of the synthetic corpus (a sparse first-order Markov chain) and of the
sampler that cuts each worker's rows from its own slice of it.

The batch of step ``s`` on worker ``w`` of ``W`` is a pure function of
``(seed, s, w, W)``: ``rows`` windows of ``seq_len + 1`` tokens at random
starts in the worker's slice, tokens the first ``seq_len``, labels the
last ``seq_len``.
"""
from __future__ import annotations

import numpy as np

CORPUS_TOKENS = 1 << 18
BRANCHING = 4
STREAM = 0xC07A


def markov_corpus(seed: int, length: int, vocab: int, branching: int = BRANCHING
                  ) -> np.ndarray:
    """Each token prefers one of ``branching`` successors; one token in 20 is
    drawn uniformly instead."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, branching), dtype=np.int32)
    probs = rng.dirichlet(np.ones(branching) * 0.5, size=vocab).astype(np.float32)
    out = np.empty(length, dtype=np.int32)
    t = int(rng.integers(0, vocab))
    u = rng.random(length, dtype=np.float32)
    explore = rng.random(length) < 0.05
    wild = rng.integers(0, vocab, size=length, dtype=np.int32)
    cum = np.cumsum(probs, axis=1)
    for i in range(length):
        if explore[i]:
            t = int(wild[i])
        else:
            j = int(np.searchsorted(cum[t], u[i]))
            t = int(succ[t, min(j, branching - 1)])
        out[i] = t
    return out


class Batches:
    """Every worker's batches of one run: ``batch(step, worker)`` ->
    ``(tokens, labels)``, int64 arrays of shape ``(rows, seq_len)``."""

    def __init__(self, seed: int, vocab: int, seq_len: int, rows: int, workers: int):
        self.seed, self.seq_len, self.rows, self.workers = seed, seq_len, rows, workers
        corpus = markov_corpus(seed, CORPUS_TOKENS, vocab)
        per = len(corpus) // workers
        self.slices = [corpus[w * per:(w + 1) * per] for w in range(workers)]

    def batch(self, step: int, worker: int) -> tuple[np.ndarray, np.ndarray]:
        corpus = self.slices[worker]
        rng = np.random.default_rng((self.seed, step, worker, STREAM))
        S = self.seq_len
        starts = rng.integers(0, len(corpus) - S - 1, size=self.rows)
        window = corpus[starts[:, None] + np.arange(S + 1)[None, :]].astype(np.int64)
        return window[:, :-1], window[:, 1:]
