"""Step builders: bind (model config × workload shape × mesh × sharding
rules × execution knobs) into one step function plus its sharding and
abstract-input trees (the JAX package's ``train/steps.py``).

The same bundles serve three consumers:
  * ``launch/dryrun.py``  — ``bundle.lower()``: the step traced on
    ``meta`` DTensors over a fake world, per-device cost and memory;
  * ``launch/train.py``   — real training on the host mesh;
  * the benchmarks       — step-level objectives for the tuner.

The reference jits each step with its shardings. The port runs it
eagerly: :meth:`StepBundle.jitted` places every argument on the mesh
(``distribute_tensor``, each rank slicing its own copy; a DTensor
already placed passes through) and runs the step under the activation
context; :meth:`StepBundle.lower` traces it on ``meta``. Where the
reference donates an argument, ``fn`` updates it in place. With
``mesh=None`` a bundle has no shardings and runs plain tensors on one
device, as before the distribution layer.

The train step's loss and gradients come from
:func:`repro_torch.models.api.loss_and_grads`, the helper the workloads'
train step also calls; with ``StepConfig.microbatches = k > 1`` the
batch is split into k micro-batches whose loss and gradients are summed
in float32 and divided by k; ``grad_bf16`` casts the gradients to
bfloat16 before the update; on a mesh each gradient is resharded to its
parameter's layout (the gradient all-reduce or reduce-scatter); then the
schedule's learning rate and :func:`repro_torch.optim.adamw_update`, in
place.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

from ..distributed import sharding as sh
from ..distributed.actctx import activation_sharding, global_stride
from ..models import api
from ..models.config import ModelConfig, WorkloadShape, input_specs
from ..models.params import empty_like_defs, flatten, map_tree, unflatten
from ..models.transformer import StepConfig
from ..optim import AdamWConfig, adamw_update, make_schedule, opt_state_defs

__all__ = ["StepBundle", "build_decode_step", "build_prefill_step",
           "build_step", "build_train_step", "default_step_cfg", "place"]

_META = torch.device("meta")


def _is_sharding(x) -> bool:
    return isinstance(x, sh.NamedSharding)


def _zip_map(fn: Callable, tree: Any, shardings: Any) -> Any:
    """``fn(leaf, sharding)`` over a tree and its sharding tree (a single
    sharding covers a whole subtree; None leaves the subtree alone)."""
    if shardings is None:
        return tree
    if _is_sharding(shardings):
        if isinstance(tree, dict):
            return {k: _zip_map(fn, v, shardings) for k, v in tree.items()}
        return fn(tree, shardings) if isinstance(tree, torch.Tensor) \
            else tree
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_map(fn, v, s)
                          for v, s in zip(tree, shardings))
    return tree


def _place_leaf(t: torch.Tensor, s: sh.NamedSharding):
    from torch.distributed.tensor import DTensor
    target = s.placements
    if isinstance(t, DTensor):
        if tuple(t.placements) == target:
            return t
        return t.redistribute(s.mesh, target)
    return s.distribute(t)


def place(tree: Any, shardings: Any) -> Any:
    """``tree`` with each tensor leaf a DTensor of its sharding (a plain
    tensor is the whole tensor, every rank slicing its own copy; a
    DTensor is redistributed where its placements differ)."""
    return _zip_map(_place_leaf, tree, shardings)


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """Everything needed to run or trace one step function."""

    fn: Callable
    abstract_args: tuple           # meta-tensor trees, in order
    in_shardings: Any = None       # NamedSharding trees, same order
    out_shardings: Any = None      # sharding tree of the outputs
    donate_argnums: tuple = ()

    def jitted(self) -> Callable:
        """The step as an eager callable: its arguments placed on the mesh
        (:func:`place`), its outputs redistributed to ``out_shardings``;
        with no mesh (no shardings), ``fn`` itself."""
        if self.in_shardings is None:
            return self.fn

        def run(*args):
            placed = tuple(place(a, s) for a, s in zip(args,
                                                         self.in_shardings))
            return place(self.fn(*placed), self.out_shardings)

        return run

    def lower(self):
        """The step traced once on ``meta`` DTensors of its abstract
        arguments (nothing allocated, nothing sent):
        a :class:`~repro_torch.analysis.trace.StepTrace` of this rank's
        FLOPs, bytes, collectives and memory."""
        from ..analysis.trace import trace_call
        if self.in_shardings is None:
            raise ValueError("a bundle without a mesh has nothing to lower")
        args = tuple(place(a, s) for a, s in zip(self.abstract_args,
                                                 self.in_shardings))
        out_shardings = self.out_shardings
        return trace_call(lambda *a: place(self.fn(*a), out_shardings),
                          args)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _batch_args(cfg: ModelConfig, shape: WorkloadShape) -> dict:
    """Meta stand-ins of every model input of the cell: tokens (B, S), or
    (B, 1) for decode, and the family's frames or image embeddings."""
    return {name: torch.empty(sd.shape, dtype=sd.dtype, device=_META)
            for name, sd in input_specs(cfg, shape).items()}


def _batch_shardings(cfg: ModelConfig, shape: WorkloadShape, mesh,
                     rules: sh.ShardingRules) -> dict:
    out = {}
    for name, sds in input_specs(cfg, shape).items():
        logical = ("batch",) + (None,) * (len(sds.shape) - 1)
        out[name] = sh.NamedSharding(mesh, sh.logical_to_spec(
            logical, sds.shape, rules, mesh))
    return out


def _resolver(mesh, rules: sh.ShardingRules):
    """Logical-axes -> NamedSharding resolver for activation constraints."""

    def resolve(logical, shape):
        return sh.NamedSharding(mesh, sh.logical_to_spec(logical, shape,
                                                         rules, mesh))

    return resolve


def _cache_shardings(cfg: ModelConfig, shape: WorkloadShape, mesh,
                     rules: sh.ShardingRules) -> Any:
    shapes = api.cache_shapes(cfg, shape)
    logical = api.cache_logical(cfg)

    def walk(shape_node, logical_node):
        if isinstance(shape_node, dict):
            return {k: walk(shape_node[k], logical_node[k])
                    for k in shape_node}
        return sh.NamedSharding(mesh, sh.logical_to_spec(
            logical_node, shape_node.shape, rules, mesh))

    return walk(shapes, logical)


def _replicated(mesh) -> sh.NamedSharding:
    return sh.NamedSharding(mesh, ())


def _context(mesh, rules: sh.ShardingRules):
    """The step's activation context: the resolver on a mesh, nothing
    without one."""
    if mesh is None:
        return contextlib.nullcontext()
    return activation_sharding(_resolver(mesh, rules))


def _logits_sharding(cfg: ModelConfig, shape: WorkloadShape, mesh,
                     rules: sh.ShardingRules) -> sh.NamedSharding:
    return sh.NamedSharding(mesh, sh.logical_to_spec(
        ("batch", None, "vocab"),
        (shape.global_batch, 1, cfg.vocab_padded), rules, mesh))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _micro_rows(x: torch.Tensor, k: int, i: int) -> torch.Tensor:
    """Micro-batch ``i`` of ``k`` of one batch leaf: rows ``i·B/k …
    (i+1)·B/k`` (the reference's reshape to (k, B/k, ...)). A DTensor
    split over its rows takes block i of every rank's local rows, so no
    row moves between ranks (on one rank, the same rows)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        rows = x.shape[0]
        return x.reshape(k, rows // k, *x.shape[1:])[i]
    local = x.to_local()
    rows = local.shape[0]
    if rows % k:
        raise ValueError(f"{rows} local rows do not split into {k} "
                         f"micro-batches")
    part = local.reshape(k, rows // k, *local.shape[1:])[i]
    shape = (x.shape[0] // k, *x.shape[1:])
    return DTensor.from_local(part, x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=global_stride(part, shape))


def _micro_batches(batch: dict, k: int) -> list[dict]:
    rows = batch["tokens"].shape[0]
    if rows % k:
        raise ValueError(f"batch of {rows} rows does not split into {k} "
                         f"micro-batches")
    return [{name: _micro_rows(x, k, i) for name, x in batch.items()}
            for i in range(k)]


def _like_params(grads: dict, params: dict) -> dict:
    """Each gradient DTensor resharded to its parameter's placements (the
    gradient all-reduce / reduce-scatter); plain tensors as they are."""
    from torch.distributed.tensor import DTensor
    g_flat, p_flat = flatten(grads), flatten(params)
    out = {}
    for path, g in g_flat.items():
        p = p_flat[path]
        if isinstance(g, DTensor) and tuple(g.placements) != \
                tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        out[path] = g
    return unflatten(out)


def build_train_step(cfg: ModelConfig, shape: WorkloadShape, mesh=None,
                     rules: Optional[sh.ShardingRules] = None,
                     step_cfg: StepConfig = StepConfig(),
                     opt_cfg: AdamWConfig = AdamWConfig(),
                     peak_lr: float = 3e-4, total_steps: int = 10_000,
                     ) -> StepBundle:
    """``fn(params, opt_state, batch, step_idx) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``; params and opt_state are updated in
    place, the metrics are 0-d tensors on the device (replicated DTensors
    on a mesh)."""
    rules = rules or sh.TRAIN_RULES
    defs = api.param_defs(cfg)
    opt_defs = opt_state_defs(defs)
    schedule = make_schedule(cfg.lr_schedule, peak_lr, total_steps)
    k = step_cfg.microbatches

    def loss_and_grads(params: dict, batch: dict):
        if k == 1:
            return api.loss_and_grads(params, batch, cfg, step_cfg)
        loss, grads = None, None
        for mb in _micro_batches(batch, k):
            l, g = api.loss_and_grads(params, mb, cfg, step_cfg)
            if grads is None:
                loss = torch.zeros_like(l, dtype=torch.float32)
                grads = map_tree(lambda _, x: torch.zeros_like(
                    x, dtype=torch.float32), g)
            loss = loss + l
            for acc, x in zip(flatten(grads).values(), flatten(g).values()):
                acc.add_(x)
            del g
        return loss / k, map_tree(lambda _, x: x.div_(k), grads)

    def train_step(params, opt_state, batch, step_idx):
        with _context(mesh, rules):
            loss, grads = loss_and_grads(params, batch)
            if step_cfg.grad_bf16:
                # halve gradient-sync traffic; Adam moments stay f32
                grads = map_tree(lambda _, g: g.to(torch.bfloat16), grads)
            if mesh is not None:
                grads = _like_params(grads, params)
            lr = schedule(step_idx, device=opt_state["count"].device)
            params, opt_state, metrics = adamw_update(params, grads,
                                                      opt_state, lr, opt_cfg)
            return params, opt_state, {"loss": loss, **metrics}

    abstract = (empty_like_defs(defs, _META),
                empty_like_defs(opt_defs, _META),
                _batch_args(cfg, shape),
                torch.empty((), dtype=torch.int32, device=_META))
    if mesh is None:
        return StepBundle(fn=train_step, abstract_args=abstract)
    param_shard = sh.sharding_tree(defs, rules, mesh)
    opt_shard = sh.sharding_tree(opt_defs, rules, mesh)
    rep = _replicated(mesh)
    return StepBundle(
        fn=train_step, abstract_args=abstract,
        in_shardings=(param_shard, opt_shard,
                      _batch_shardings(cfg, shape, mesh, rules), rep),
        out_shardings=(param_shard, opt_shard,
                       {"loss": rep, "grad_norm": rep, "lr": rep}),
        donate_argnums=(0, 1))


# ---------------------------------------------------------------------------
# prefill / decode steps
# ---------------------------------------------------------------------------


def build_prefill_step(cfg: ModelConfig, shape: WorkloadShape, mesh=None,
                       rules: Optional[sh.ShardingRules] = None,
                       step_cfg: StepConfig = StepConfig()) -> StepBundle:
    """``fn(params, batch) -> (last logits, cache)``."""
    rules = rules or sh.SERVE_RULES
    defs = api.param_defs(cfg)

    def prefill_step(params, batch):
        with torch.no_grad(), _context(mesh, rules):
            return api.prefill_fn(params, batch, cfg, step_cfg)

    abstract = (empty_like_defs(defs, _META), _batch_args(cfg, shape))
    if mesh is None:
        return StepBundle(fn=prefill_step, abstract_args=abstract)
    return StepBundle(
        fn=prefill_step, abstract_args=abstract,
        in_shardings=(sh.sharding_tree(defs, rules, mesh),
                      _batch_shardings(cfg, shape, mesh, rules)),
        out_shardings=(_logits_sharding(cfg, shape, mesh, rules),
                       _cache_shardings(cfg, shape, mesh, rules)))


def build_decode_step(cfg: ModelConfig, shape: WorkloadShape, mesh=None,
                      rules: Optional[sh.ShardingRules] = None,
                      step_cfg: StepConfig = StepConfig()) -> StepBundle:
    """``fn(params, batch, cache, pos) -> (logits, cache)``; the KV cache
    is written in place."""
    rules = rules or sh.SERVE_RULES
    defs = api.param_defs(cfg)

    def decode_step(params, batch, cache, pos):
        with torch.no_grad(), _context(mesh, rules):
            return api.decode_fn(params, batch, cache, pos, cfg, step_cfg)

    abstract = (empty_like_defs(defs, _META), _batch_args(cfg, shape),
                api.cache_init(cfg, shape, _META),
                torch.empty((), dtype=torch.int32, device=_META))
    if mesh is None:
        return StepBundle(fn=decode_step, abstract_args=abstract)
    cache_shard = _cache_shardings(cfg, shape, mesh, rules)
    return StepBundle(
        fn=decode_step, abstract_args=abstract,
        in_shardings=(sh.sharding_tree(defs, rules, mesh),
                      _batch_shardings(cfg, shape, mesh, rules),
                      cache_shard, _replicated(mesh)),
        out_shardings=(_logits_sharding(cfg, shape, mesh, rules),
                       cache_shard),
        donate_argnums=(2,))


def default_step_cfg(cfg: ModelConfig, shape: WorkloadShape) -> StepConfig:
    """Per-arch execution defaults: large models accumulate gradients over
    microbatches to bound the per-layer residual stacks."""
    if shape.kind == "train" and cfg.n_params() > 10e9:
        return StepConfig(microbatches=4)
    return StepConfig()


def build_step(cfg: ModelConfig, shape: WorkloadShape, mesh=None,
               rules: Optional[sh.ShardingRules] = None,
               step_cfg: Optional[StepConfig] = None) -> StepBundle:
    """Dispatch on the workload kind (train/prefill/decode)."""
    if step_cfg is None:
        step_cfg = default_step_cfg(cfg, shape)
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, rules, step_cfg)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, rules, step_cfg)
    return build_decode_step(cfg, shape, mesh, rules, step_cfg)
