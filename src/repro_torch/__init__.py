"""PyTorch/CUDA port of the CI-pruned autotuner (the JAX package ``repro``
is the reference).

Layout mirrors ``repro``: ``core`` (search space, strategies, two-level
evaluator, trial cache, roofline report), ``kernels`` (hand-written CUDA
kernels with their plain PyTorch versions), ``bench`` (the paper's DGEMM
and TRIAD benchmarks plus the tiled-GEMM tile search) and the ``tune``
CLI (``python -m repro_torch.tune``). Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; nothing here imports ``jax`` or
``repro``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
