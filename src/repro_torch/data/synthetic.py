"""Deterministic synthetic corpus (numpy), the same stream as
``repro.data.synthetic.markov_corpus`` for the same arguments.

``markov_corpus`` produces *learnable* token streams (a random sparse
first-order Markov chain): a model that trains correctly drives the loss
well below the unigram entropy.  ``zipf_tokens`` gives heavy-tailed unigram
data for throughput-only runs.
"""
from __future__ import annotations

import numpy as np


def zipf_tokens(rng: np.random.Generator, n: int, vocab: int, a: float = 1.3):
    toks = rng.zipf(a, size=n).astype(np.int64)
    return (toks % vocab).astype(np.int32)


def markov_corpus(
    seed: int, length: int, vocab: int, branching: int = 4
) -> np.ndarray:
    """Each token deterministically prefers one of ``branching`` successors."""
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
