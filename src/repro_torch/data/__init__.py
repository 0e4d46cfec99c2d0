"""Deterministic synthetic data pipeline (resumable), the JAX package's
``data``."""

from .pipeline import (DataConfig, SyntheticLM, make_batch_sharded,
                       markov_tokens)

__all__ = ["DataConfig", "SyntheticLM", "make_batch_sharded",
           "markov_tokens"]
