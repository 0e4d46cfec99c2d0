"""Deterministic synthetic data pipeline (resumable), the JAX package's
``data``."""

from .pipeline import DataConfig, SyntheticLM, markov_tokens

__all__ = ["DataConfig", "SyntheticLM", "markov_tokens"]
