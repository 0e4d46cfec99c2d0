"""PyTorch/CUDA port of the CI-pruned autotuner (the JAX package ``repro``
is the reference).

Layout mirrors ``repro``: ``core`` (search space, strategies, two-level
evaluator, trial cache, roofline report), ``kernels`` (hand-written CUDA
kernels with their plain PyTorch versions: GEMM, TRIAD, flash
attention), ``models`` and ``configs`` (the dense model stack and the
ten architecture configs), ``bench`` (the paper's DGEMM and TRIAD
benchmarks, the tiled-GEMM tile search and the whole-model train step
over the flash tiles, the shape-sweep families), ``obs`` (span tracing,
device timing), ``history`` (the run ledger, the regression gate and the
HTML dashboard), ``surrogate`` (model-guided strategies), ``sweep``
(shape-sweep campaigns and their config oracle) and the CLIs ``python -m
repro_torch.tune``, ``repro_torch.perf_gate``, ``repro_torch.sweep`` and
``repro_torch.roofline_report``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; nothing here imports ``jax`` or
``repro``.
"""

from . import configs, kernels, models
from .device import resolve_device

__all__ = ["configs", "kernels", "models", "resolve_device"]
