"""Fault-tolerant checkpointing: atomic saves, manifests, retention (the
JAX package's ``checkpoint``)."""

from .manager import CheckpointManager, load_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint"]
