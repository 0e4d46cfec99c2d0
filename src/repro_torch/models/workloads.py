"""Whole-model workloads as timed callables (the JAX package's
``models/workloads.py``).

A workload is a named callable with concrete example arguments. The
benchmark layer (:func:`repro_torch.bench.common.model_step_family`)
turns a model step into a tuning objective whose search space is the
flash-attention tiles of :class:`~repro_torch.models.transformer.StepConfig`.

The work term (:func:`workload_flops`) replaces the reference's
compiler-reported cost: ``torch.utils.flop_counter.FlopCounterMode``
counts the matrix products of one call of the workload's own entry
point (the train step with ``use_flash=0`` and no remat; ``prefill_fn``;
``decode_fn``) on the ``meta`` device, where every kernel takes its
plain version, once per (kind, config, batch, sequence). Every tuner
config of one model reuses that count, so the GFLOP/s the tuner
maximizes ranks configs by time alone; XLA's count, by contrast,
changes with the implementation it costs.

Every step kind is built for every family; a decode step runs one token
per sequence from a zero cache at position 0, and writes its KV cache in
place, the same slot at every call. An enc-dec batch also holds zero
frame embeddings and a VLM batch normal image embeddings, drawn from the
workload's seeded generator (:func:`model_inputs`), as the reference's
``_model_batch`` builds them.
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
           "build_workload", "decode_step", "meta_step", "model_inputs",
           "prefill_step",
           "resolve_arch", "step_flops", "train_step", "workload_flops"]

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


@dataclasses.dataclass(frozen=True)
class ModelWorkload:
    """One named workload: ``fn(*args)`` is what gets timed; ``args`` are
    real tensors on the workload's device (deterministic: seeded weights
    and tokens)."""

    name: str
    kind: str                    # train | prefill | decode | kernel
    fn: Callable
    args: tuple
    cfg: Optional[ModelConfig]   # None for raw-kernel workloads (dgemm)
    step: Optional[StepConfig]
    shape: Optional[WorkloadShape]
    declared_flops: Optional[float] = None  # analytic, when one exists

    def with_step(self, step: StepConfig) -> "ModelWorkload":
        """The same weights and inputs under other execution knobs."""
        if self.kind not in _STEP_FNS:
            raise ValueError(f"{self.name} has no step config")
        return dataclasses.replace(
            self, step=step,
            fn=functools.partial(_STEP_FNS[self.kind], cfg=self.cfg,
                                 step=step))


def train_step(params: dict, batch: dict, *, cfg: ModelConfig,
               step: StepConfig) -> tuple[torch.Tensor, dict]:
    """Loss and the gradient of every parameter leaf (same tree):
    :func:`repro_torch.models.api.loss_and_grads`."""
    return api.loss_and_grads(params, batch, cfg, step)


def prefill_step(params: dict, batch: dict, *, cfg: ModelConfig,
                 step: StepConfig) -> tuple[torch.Tensor, dict]:
    """Last-position logits and the decode cache of a prompt batch."""
    with torch.no_grad():
        return api.prefill_fn(params, batch, cfg, step)


def decode_step(params: dict, batch: dict, cache: dict, pos, *,
                cfg: ModelConfig, step: StepConfig
                ) -> tuple[torch.Tensor, dict]:
    """Logits of one token per sequence and the advanced cache."""
    with torch.no_grad():
        return api.decode_fn(params, batch, cache, pos, cfg, step)


_STEP_FNS = {"train": train_step, "prefill": prefill_step,
             "decode": decode_step}


def _tiny_shape(kind: str, batch: int, seq: int) -> WorkloadShape:
    return WorkloadShape(name=f"tiny_{kind}", seq_len=seq,
                         global_batch=batch, kind=kind)


def _tokens(batch: int, seq: int, vocab: int,
            device: torch.device) -> torch.Tensor:
    rng = np.random.default_rng(TOKEN_SEED)
    return torch.from_numpy(rng.integers(0, vocab, (batch, seq))).to(device)


def model_inputs(cfg: ModelConfig, batch: int, device: torch.device,
                 gen: Optional[torch.Generator] = None) -> dict:
    """The inputs besides the tokens that ``cfg``'s family takes: zero
    ``frames`` (B, n_frames, d_enc) for enc-dec, ``image_embeds`` (B,
    n_image_tokens, d_model) for a VLM, standard normals drawn in float32
    from ``gen`` (uninitialized tensors without one: the ``meta``
    device's stand-ins)."""
    out = {}
    if cfg.family == "encdec":
        out["frames"] = torch.zeros((batch, cfg.n_frames, cfg.d_enc),
                                    dtype=cfg.tdtype, device=device)
    if cfg.family == "vlm":
        shape = (batch, cfg.n_image_tokens, cfg.d_model)
        if gen is None:
            out["image_embeds"] = torch.empty(shape, dtype=cfg.tdtype,
                                              device=device)
        else:
            out["image_embeds"] = torch.randn(
                shape, generator=gen, dtype=torch.float32,
                device=device).to(cfg.tdtype)
    return out


def resolve_arch(arch: Union[str, ModelConfig, None]) -> ModelConfig:
    """An architecture name (its SMOKE config), a config, or None (the
    tiny dense toy) as a :class:`ModelConfig`."""
    if arch is None:
        return TINY_CONFIG
    if isinstance(arch, ModelConfig):
        return arch
    from ..configs import get_smoke
    return get_smoke(arch)


def _build_step(kind: str, cfg: ModelConfig, step: StepConfig,
                batch_size: int, seq: int,
                device: torch.device) -> ModelWorkload:
    """The ``kind`` step of ``cfg`` on seeded weights: the train step or
    ``prefill_step`` on (B, S) tokens, or ``decode_step`` of one token per
    sequence from a zero cache at position 0."""
    name = f"{kind}_step"
    gen = torch.Generator(device=device).manual_seed(PARAM_SEED)
    params = materialize(gen, api.param_defs(cfg))
    shape = _tiny_shape(kind, batch_size, seq)
    tokens = _tokens(batch_size, 1 if kind == "decode" else seq,
                     cfg.vocab_size, device)
    args: tuple = (params, {"tokens": tokens,
                            **model_inputs(cfg, batch_size, device, gen)})
    if kind == "decode":
        args += (api.cache_init(cfg, shape, device), 0)
    return ModelWorkload(name=name, kind=kind,
                         fn=functools.partial(_STEP_FNS[kind], cfg=cfg,
                                              step=step),
                         args=args, cfg=cfg, step=step, shape=shape)


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
    return _build_step(name[:-len("_step")], resolve_arch(arch),
                       step or StepConfig(remat=False), batch_size, seq_len,
                       dev)


def meta_step(cfg: ModelConfig, batch_size: int, seq_len: int,
              kind: str = "train", step: Optional[StepConfig] = None,
              ) -> tuple[Callable, tuple]:
    """One ``kind`` step of ``cfg`` and its arguments on the ``meta``
    device (weights, tokens, and for decode a zero cache at position 0):
    the step's shapes and ops with nothing allocated. ``step`` defaults
    to the plain path (``use_flash=0``, no remat)."""
    meta = torch.device("meta")
    params = empty_like_defs(api.param_defs(cfg), meta)
    step = step or StepConfig(use_flash=False, remat=False)
    tokens = torch.empty((batch_size, 1 if kind == "decode" else seq_len),
                         dtype=torch.int64, device=meta)
    args: tuple = (params, {"tokens": tokens,
                            **model_inputs(cfg, batch_size, meta)})
    if kind == "decode":
        shape = _tiny_shape(kind, batch_size, seq_len)
        args += (api.cache_init(cfg, shape, meta), 0)
    return functools.partial(_STEP_FNS[kind], cfg=cfg, step=step), args


@functools.lru_cache(maxsize=None)
def step_flops(cfg: ModelConfig, batch_size: int, seq_len: int,
               kind: str = "train") -> float:
    """Matrix-product FLOPs of one ``kind`` step of ``cfg`` (train: the
    plain path, ``use_flash=0``, no remat; prefill: ``prefill_fn`` over
    (B, S) tokens; decode: ``decode_fn`` of one token from a zero cache),
    counted on the ``meta`` device (:func:`meta_step`); the SSD chunk
    scan's op counts its kernel's own work (its FLOP formula)."""
    fn, args = meta_step(cfg, batch_size, seq_len, kind)
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def workload_flops(workload: ModelWorkload) -> float:
    """The work term of one call: the analytic count of a kernel
    workload, or the matrix-product FLOPs of one call of the workload's
    own step, counted once per (kind, config, batch, sequence) on the
    ``meta`` device and shared by every step config."""
    if workload.declared_flops is not None:
        return workload.declared_flops
    shape = workload.shape
    return step_flops(workload.cfg, shape.global_batch, shape.seq_len,
                      workload.kind)
