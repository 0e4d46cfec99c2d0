"""Step builders: bind (model config × workload shape × execution knobs)
into one step function plus its abstract inputs (the JAX package's
``train/steps.py``).

The reference jits each step with its sharding trees over a mesh, for
the dry run, the training launcher and the benchmarks. On one card the
port runs the step eagerly: a bundle holds the function and its
arguments as ``meta`` tensors (shapes and dtypes, nothing allocated).
Where the reference donates an argument, ``fn`` updates it in place.
The sharding trees and the dry run's lowering belong to distribution.

The train step's loss and gradients come from
:func:`repro_torch.models.api.loss_and_grads`, the helper the workloads'
train step also calls; with ``StepConfig.microbatches = k > 1`` the
batch is split into k micro-batches whose loss and gradients are summed
in float32 and divided by k; ``grad_bf16`` casts the gradients to
bfloat16 before the update; then the schedule's learning rate and
:func:`repro_torch.optim.adamw_update`, in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..models import api
from ..models.config import ModelConfig, WorkloadShape
from ..models.params import empty_like_defs, flatten, map_tree
from ..models.transformer import StepConfig
from ..models.workloads import model_inputs
from ..optim import AdamWConfig, adamw_update, make_schedule, opt_state_defs

__all__ = ["StepBundle", "build_decode_step", "build_prefill_step",
           "build_step", "build_train_step", "default_step_cfg"]

_META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """One step function with its abstract arguments."""

    fn: Callable
    abstract_args: tuple           # meta-tensor trees, in order


def _batch_args(cfg: ModelConfig, shape: WorkloadShape) -> dict:
    """Meta stand-ins of every model input of the cell: tokens (B, S), or
    (B, 1) for decode, and the family's frames or image embeddings."""
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    return {"tokens": torch.empty((b, s), dtype=torch.int64, device=_META),
            **model_inputs(cfg, b, _META)}


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _micro_batches(batch: dict, k: int) -> list[dict]:
    """Batch row blocks ``i·B/k … (i+1)·B/k`` (the reference's reshape to
    (k, B/k, ...))."""
    rows = batch["tokens"].shape[0]
    if rows % k:
        raise ValueError(f"batch of {rows} rows does not split into {k} "
                         f"micro-batches")
    return [{name: x.reshape(k, rows // k, *x.shape[1:])[i]
             for name, x in batch.items()} for i in range(k)]


def build_train_step(cfg: ModelConfig, shape: WorkloadShape,
                     step_cfg: StepConfig = StepConfig(),
                     opt_cfg: AdamWConfig = AdamWConfig(),
                     peak_lr: float = 3e-4, total_steps: int = 10_000,
                     ) -> StepBundle:
    """``fn(params, opt_state, batch, step_idx) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``; params and opt_state are updated in
    place, the metrics are 0-d tensors on the device."""
    defs = api.param_defs(cfg)
    schedule = make_schedule(cfg.lr_schedule, peak_lr, total_steps)
    k = step_cfg.microbatches

    def loss_and_grads(params: dict, batch: dict):
        if k == 1:
            return api.loss_and_grads(params, batch, cfg, step_cfg)
        loss, grads = None, None
        for mb in _micro_batches(batch, k):
            l, g = api.loss_and_grads(params, mb, cfg, step_cfg)
            if grads is None:
                loss = torch.zeros((), dtype=torch.float32, device=l.device)
                grads = map_tree(lambda _, x: torch.zeros_like(
                    x, dtype=torch.float32), g)
            loss = loss + l
            for acc, x in zip(flatten(grads).values(), flatten(g).values()):
                acc.add_(x)
            del g
        return loss / k, map_tree(lambda _, x: x.div_(k), grads)

    def train_step(params, opt_state, batch, step_idx):
        loss, grads = loss_and_grads(params, batch)
        if step_cfg.grad_bf16:
            # halve gradient-sync traffic; Adam moments stay f32
            grads = map_tree(lambda _, g: g.to(torch.bfloat16), grads)
        lr = schedule(step_idx, device=opt_state["count"].device)
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  lr, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics}

    return StepBundle(
        fn=train_step,
        abstract_args=(empty_like_defs(defs, _META),
                       empty_like_defs(opt_state_defs(defs), _META),
                       _batch_args(cfg, shape),
                       torch.empty((), dtype=torch.int32, device=_META)),
    )


# ---------------------------------------------------------------------------
# prefill / decode steps
# ---------------------------------------------------------------------------


def build_prefill_step(cfg: ModelConfig, shape: WorkloadShape,
                       step_cfg: StepConfig = StepConfig()) -> StepBundle:
    """``fn(params, batch) -> (last logits, cache)``."""
    defs = api.param_defs(cfg)

    def prefill_step(params, batch):
        with torch.no_grad():
            return api.prefill_fn(params, batch, cfg, step_cfg)

    return StepBundle(fn=prefill_step,
                      abstract_args=(empty_like_defs(defs, _META),
                                     _batch_args(cfg, shape)))


def build_decode_step(cfg: ModelConfig, shape: WorkloadShape,
                      step_cfg: StepConfig = StepConfig()) -> StepBundle:
    """``fn(params, batch, cache, pos) -> (logits, cache)``; the KV cache
    is written in place."""
    defs = api.param_defs(cfg)

    def decode_step(params, batch, cache, pos):
        with torch.no_grad():
            return api.decode_fn(params, batch, cache, pos, cfg, step_cfg)

    return StepBundle(
        fn=decode_step,
        abstract_args=(empty_like_defs(defs, _META), _batch_args(cfg, shape),
                       api.cache_init(cfg, shape, _META),
                       torch.empty((), dtype=torch.int32, device=_META)),
    )


def default_step_cfg(cfg: ModelConfig, shape: WorkloadShape) -> StepConfig:
    """Per-arch execution defaults: large models accumulate gradients over
    microbatches to bound the per-layer residual stacks."""
    if shape.kind == "train" and cfg.n_params() > 10e9:
        return StepConfig(microbatches=4)
    return StepConfig()


def build_step(cfg: ModelConfig, shape: WorkloadShape,
               step_cfg: Optional[StepConfig] = None) -> StepBundle:
    """Dispatch on the workload kind (train/prefill/decode)."""
    if step_cfg is None:
        step_cfg = default_step_cfg(cfg, shape)
    if shape.kind == "train":
        return build_train_step(cfg, shape, step_cfg)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, step_cfg)
    return build_decode_step(cfg, shape, step_cfg)
