from .pipeline import DataConfig, ShardedLoader, make_loader
from .synthetic import markov_corpus

__all__ = ["DataConfig", "ShardedLoader", "make_loader", "markov_corpus"]
