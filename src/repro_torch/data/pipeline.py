"""Sharded data loader: per-(step, worker) batches drawn from the synthetic
corpus, as ``repro.data.pipeline.ShardedLoader`` draws them, yielded as
``int64`` tensors on the requested device.

Each data-parallel worker reads its own disjoint slice of the corpus.  The
batch of step ``s`` is a pure function of ``(seed, s, worker)``, so the
loader yields exactly the reference's token arrays.  Batches are made on
the host when they are asked for; there is no prefetch thread.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..obs.spans import span
from .synthetic import markov_corpus


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    corpus_tokens: int = 1 << 18
    seed: int = 0


class ShardedLoader:
    def __init__(self, cfg: DataConfig, num_workers: int = 1, worker: int = 0,
                 *, device: str | torch.device = "cuda"):
        if cfg.global_batch % num_workers:
            raise ValueError(
                f"global_batch {cfg.global_batch} is not divisible by "
                f"{num_workers} workers"
            )
        self.cfg = cfg
        self.num_workers = num_workers
        self.worker = worker
        self.device = resolve_device(device)
        self.local_batch = cfg.global_batch // num_workers
        corpus = markov_corpus(cfg.seed, cfg.corpus_tokens, cfg.vocab_size)
        per = len(corpus) // num_workers
        self.corpus = corpus[worker * per : (worker + 1) * per]

    def make_numpy(self, step: int) -> dict[str, np.ndarray]:
        """The batch of ``step`` as int32 numpy arrays (the reference's
        ``ShardedLoader._make`` before its ``jnp.asarray``)."""
        rng = np.random.default_rng((self.cfg.seed, step, self.worker, 0xC07A))
        S = self.cfg.seq_len
        starts = rng.integers(0, len(self.corpus) - S - 1, size=self.local_batch)
        idx = starts[:, None] + np.arange(S + 1)[None, :]
        window = self.corpus[idx]
        return {"tokens": window[:, :-1], "labels": window[:, 1:]}

    def make(self, step: int) -> dict[str, torch.Tensor]:
        """The batch of ``step`` on the device: drawn on the host (span
        ``data/draw``), then copied (span ``data/copy``)."""
        with span("data/draw"):
            arrays = self.make_numpy(step)
        with span("data/copy"):
            return {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device, torch.int64
                )
                for k, v in arrays.items()
            }

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.make(step)
            step += 1


def make_loader(cfg: DataConfig, num_workers: int = 1, worker: int = 0, *,
                device: str | torch.device = "cuda") -> ShardedLoader:
    return ShardedLoader(cfg, num_workers, worker, device=device)


def synth_batch(seed: int, cfg, shape_kind: str, batch: int, seq: int, *,
                device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """A random batch for smoke tests: uniform ``tokens`` (and ``labels``
    for ``shape_kind="train"``) in ``[0, cfg.vocab_size)``, int64, drawn
    from a torch generator seeded with ``seed`` (the reference draws from a
    ``jax.random`` key, so the values differ; the shapes and range agree)."""
    gen = torch.Generator().manual_seed(int(seed))
    shape = (batch, seq)
    out = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen)}
    if shape_kind == "train":
        out["labels"] = torch.randint(0, cfg.vocab_size, shape, generator=gen)
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in out.items()}
