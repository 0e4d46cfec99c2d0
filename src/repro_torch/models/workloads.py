"""Whole-model workloads as timed callables (the JAX package's
``models/workloads.py``).

A workload is a named callable with concrete example arguments. The
benchmark layer (:func:`repro_torch.bench.common.model_step_family`)
turns a train step into a tuning objective whose search space is the
flash-attention tiles of :class:`~repro_torch.models.transformer.StepConfig`.

The work term (:func:`workload_flops`) replaces the reference's
compiler-reported cost: ``torch.utils.flop_counter.FlopCounterMode``
counts the matrix products of one step on the plain path
(``use_flash=0``, no remat) on the ``meta`` device, once per (config,
batch, sequence). Every tuner config of one model reuses that count, so
the GFLOP/s the tuner maximizes ranks configs by step time alone; XLA's
count, by contrast, changes with the implementation it costs.

Only ``train_step`` and ``dgemm`` are ported; ``prefill_step`` and
``decode_step`` belong to the serving slice and raise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..device import resolve_device
from . import api
from .config import ModelConfig, WorkloadShape
from .params import empty_like_defs, materialize
from .transformer import StepConfig

__all__ = ["ModelWorkload", "TINY_CONFIG", "WORKLOAD_NAMES",
           "build_workload", "step_flops", "train_step", "workload_flops"]

# Small enough to run in milliseconds on the host, big enough that the
# matrix products dominate.
TINY_CONFIG = ModelConfig(
    name="tiny-dense",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    norm="rmsnorm",
    dtype="float32",
)

_TINY_BATCH = 2
_TINY_SEQ = 64
#: seeds of the weights (torch generator) and the tokens (numpy)
PARAM_SEED = 0
TOKEN_SEED = 1

WORKLOAD_NAMES = ("train_step", "prefill_step", "decode_step", "dgemm")
_SERVING_TODO = ("{name} is not ported yet (ROADMAP.md, 'Still to port': "
                 "the serving slice)")


@dataclasses.dataclass(frozen=True)
class ModelWorkload:
    """One named workload: ``fn(*args)`` is what gets timed; ``args`` are
    real tensors on the workload's device (deterministic: seeded weights
    and tokens)."""

    name: str
    kind: str                    # train | kernel
    fn: Callable
    args: tuple
    cfg: Optional[ModelConfig]   # None for raw-kernel workloads (dgemm)
    step: Optional[StepConfig]
    shape: Optional[WorkloadShape]
    declared_flops: Optional[float] = None  # analytic, when one exists

    def with_step(self, step: StepConfig) -> "ModelWorkload":
        """The same weights and tokens under other execution knobs."""
        if self.kind != "train":
            raise ValueError(f"{self.name} has no step config")
        return dataclasses.replace(
            self, step=step,
            fn=functools.partial(train_step, cfg=self.cfg, step=step))


def _leaves(tree: dict) -> list[torch.Tensor]:
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _rebuild(tree: dict, leaves) -> dict:
    return {k: _rebuild(v, leaves) if isinstance(v, dict) else next(leaves)
            for k, v in tree.items()}


def train_step(params: dict, batch: dict, *, cfg: ModelConfig,
               step: StepConfig) -> tuple[torch.Tensor, dict]:
    """Loss and the gradient of every parameter leaf (same tree), by
    ``torch.autograd.grad`` (the reference's ``jax.value_and_grad``)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in _leaves(params)]
        loss = api.loss_fn(_rebuild(params, iter(leaves)), batch, cfg, step)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _rebuild(params, iter(grads))


def _tiny_shape(kind: str, batch: int, seq: int) -> WorkloadShape:
    return WorkloadShape(name=f"tiny_{kind}", seq_len=seq,
                         global_batch=batch, kind=kind)


def _tokens(batch: int, seq: int, vocab: int,
            device: torch.device) -> torch.Tensor:
    rng = np.random.default_rng(TOKEN_SEED)
    return torch.from_numpy(rng.integers(0, vocab, (batch, seq))).to(device)


def _resolve_arch(arch: Union[str, ModelConfig, None]) -> ModelConfig:
    if arch is None:
        return TINY_CONFIG
    if isinstance(arch, ModelConfig):
        return arch
    from ..configs import get_smoke
    return get_smoke(arch)


def _build_train(cfg: ModelConfig, step: StepConfig, batch_size: int,
                 seq: int, device: torch.device) -> ModelWorkload:
    gen = torch.Generator(device=device).manual_seed(PARAM_SEED)
    params = materialize(gen, api.param_defs(cfg))
    batch = {"tokens": _tokens(batch_size, seq, cfg.vocab_size, device)}
    return ModelWorkload(name="train_step", kind="train",
                         fn=functools.partial(train_step, cfg=cfg, step=step),
                         args=(params, batch), cfg=cfg, step=step,
                         shape=_tiny_shape("train", batch_size, seq))


def _build_dgemm(m: int, n: int, k: int,
                 device: torch.device) -> ModelWorkload:
    """DGEMM with an exact analytic FLOP count (2·m·n·k)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
    return ModelWorkload(name="dgemm", kind="kernel", fn=torch.matmul,
                         args=(a.to(device), b.to(device)), cfg=None,
                         step=None, shape=None,
                         declared_flops=2.0 * m * n * k)


def build_workload(name: str, arch: Union[str, ModelConfig, None] = None,
                   *, step: Optional[StepConfig] = None,
                   batch_size: int = _TINY_BATCH, seq_len: int = _TINY_SEQ,
                   m: int = 128, n: int = 128, k: int = 128,
                   device: "str | torch.device" = "cuda") -> ModelWorkload:
    """Build one named workload with concrete inputs on ``device``.

    ``arch`` is an architecture name from :mod:`repro_torch.configs` (its
    SMOKE config, as in the reference) or a :class:`ModelConfig` (a full
    configuration, possibly cut in depth); the default is
    :data:`TINY_CONFIG`. ``step`` carries the execution knobs, including
    the flash-attention tiles.
    """
    if name not in WORKLOAD_NAMES:
        raise ValueError(
            f"unknown workload {name!r}; expected one of {WORKLOAD_NAMES}")
    dev = resolve_device(device)
    if name == "dgemm":
        return _build_dgemm(m, n, k, dev)
    if name != "train_step":
        raise NotImplementedError(_SERVING_TODO.format(name=name))
    return _build_train(_resolve_arch(arch), step or StepConfig(remat=False),
                        batch_size, seq_len, dev)


@functools.lru_cache(maxsize=None)
def step_flops(cfg: ModelConfig, batch_size: int, seq_len: int) -> float:
    """Matrix-product FLOPs of one train step of ``cfg`` on the plain
    path (``use_flash=0``, no remat), counted on the ``meta`` device."""
    meta = torch.device("meta")
    params = empty_like_defs(api.param_defs(cfg), meta)
    tokens = torch.empty((batch_size, seq_len), dtype=torch.int64,
                         device=meta)
    with FlopCounterMode(display=False) as counter:
        train_step(params, {"tokens": tokens}, cfg=cfg,
                   step=StepConfig(use_flash=False, remat=False))
    return float(counter.get_total_flops())


def workload_flops(workload: ModelWorkload) -> float:
    """The work term of one call: the analytic count of a kernel
    workload, or the matrix-product FLOPs of one train step on the plain
    path, counted once per (config, batch, sequence) on the ``meta``
    device and shared by every step config."""
    if workload.declared_flops is not None:
        return workload.declared_flops
    shape = workload.shape
    return step_flops(workload.cfg, shape.global_batch, shape.seq_len)
