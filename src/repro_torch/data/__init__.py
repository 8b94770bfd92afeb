from .pipeline import DataConfig, ShardedLoader, make_loader, synth_batch
from .synthetic import markov_corpus, zipf_tokens

__all__ = [
    "DataConfig",
    "ShardedLoader",
    "make_loader",
    "markov_corpus",
    "synth_batch",
    "zipf_tokens",
]
