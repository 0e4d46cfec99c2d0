"""The distribution layer against the JAX package's: the sharding rules'
specs for every leaf of all ten configs, the local shard of a DTensor at
mesh coordinates of a fake world against the reference's slice, the
activation context, and the world-size-1 sharded path (``gloo`` on the
CPU) against the unsharded one: model forwards, the train, prefill and
decode bundles, the training launcher, and the sharded batch.

Tolerances: none. Specs and slices are compared exactly; a step through a
one-rank mesh runs the very ops of the unsharded step on the same
tensors, so its outputs are compared bitwise (``torch.equal``)."""

import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.distributed import sharding as jax_sh
from repro.launch.perf import DP_ONLY as JAX_DP_ONLY
from repro.models import api as jax_api
from repro.models.config import SHAPES as JAX_SHAPES
from repro.models.config import input_specs as jax_input_specs
from repro.optim import opt_state_defs as jax_opt_state_defs
from repro_torch import configs
from repro_torch.data import (DataConfig, SyntheticLM, make_batch_sharded,
                              markov_tokens)
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.actctx import activation_sharding, shard_act
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     release_world)
from repro_torch.launch.perf import DP_ONLY
from repro_torch.models import api
from repro_torch.models.config import SHAPES, WorkloadShape, input_specs
from repro_torch.models.params import (flatten, logical_tree, materialize,
                                       unflatten)
from repro_torch.models.transformer import StepConfig
from repro_torch.optim import adamw_init, opt_state_defs
from repro_torch.train import steps

REPO = pathlib.Path(__file__).resolve().parent.parent
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x1": {"data": 1, "model": 1}}
RULES = {"train": (sh.TRAIN_RULES, jax_sh.TRAIN_RULES),
         "serve": (sh.SERVE_RULES, jax_sh.SERVE_RULES),
         "dp-only": (sh.TRAIN_RULES.replace(**DP_ONLY),
                     jax_sh.TRAIN_RULES.replace(**JAX_DP_ONLY))}


@pytest.fixture
def world():
    """No process group before or after the test (a process has one)."""
    release_world()
    yield
    release_world()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _port_cells(cfg, shape):
    """(path, logical, shape) of every param, opt-state, cache and input
    leaf of one cell in the port."""
    defs = api.param_defs(cfg)
    for tag, tree in (("param", defs), ("opt", opt_state_defs(defs))):
        for path, d in _leaves(tree):
            yield f"{tag}{path}", d.logical, d.shape
    logical = dict(_leaves(api.cache_logical(cfg)))
    for path, s in _leaves(api.cache_shapes(cfg, shape)):
        yield f"cache{path}", logical[path], tuple(s.shape)
    for name, s in input_specs(cfg, shape).items():
        yield f"input/{name}", ("batch",) + (None,) * (len(s.shape) - 1), \
            tuple(s.shape)


def _jax_cells(cfg, shape):
    defs = jax_api.param_defs(cfg)
    for tag, tree in (("param", defs), ("opt", jax_opt_state_defs(defs))):
        for path, d in _leaves(tree):
            yield f"{tag}{path}", d.logical, d.shape
    logical = dict(_leaves(jax_api.cache_logical(cfg)))
    for path, s in _leaves(jax_api.cache_shapes(cfg, shape)):
        yield f"cache{path}", logical[path], tuple(s.shape)
    for name, s in jax_input_specs(cfg, shape).items():
        yield f"input/{name}", ("batch",) + (None,) * (len(s.shape) - 1), \
            tuple(s.shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rules_name", list(RULES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_equal_the_references(arch, rules_name, mesh_name):
    """Every param, opt-state, cache and input leaf of the cell (decode
    shape: all four kinds) resolves to the reference's PartitionSpec;
    JAX's resolver reads only ``mesh.shape``."""
    port_rules, jax_rules = RULES[rules_name]
    mesh = types.SimpleNamespace(shape=MESHES[mesh_name])
    cfg, jcfg = configs.get(arch), jax_configs.get(arch)
    port = {p: sh.logical_to_spec(lg, s, port_rules, mesh)
            for p, lg, s in _port_cells(cfg, SHAPES["decode_32k"])}
    want = {p: tuple(jax_sh.logical_to_spec(lg, s, jax_rules, mesh))
            for p, lg, s in _jax_cells(jcfg, JAX_SHAPES["decode_32k"])}
    assert port.keys() == want.keys()
    # a PartitionSpec drops no trailing None: compare padded tuples
    for path in want:
        w = want[path] + (None,) * (len(port[path]) - len(want[path]))
        assert port[path] == w, path


def test_spec_tree_and_logical_tree_follow_the_defs():
    cfg = configs.get("granite_3_2b")
    defs = api.param_defs(cfg)
    mesh = types.SimpleNamespace(shape=MESHES["16x16"])
    specs = flatten(sh.spec_tree(defs, sh.TRAIN_RULES, mesh))
    logical = flatten(logical_tree(defs))
    assert specs["layers/attn/wq"] == (None, "data", "model", None)
    assert logical["layers/attn/wq"] == ("layers", "embed", "heads",
                                         "head_dim")
    assert specs["embed/table"] == ("model", "data")
    assert sh.activation_spec(sh.TRAIN_RULES, mesh,
                              ("batch", "act_seq", "act_embed"),
                              (256, 4096, 2048)) == ("data", "model", None)


def _jax_slice(spec, shape, sizes, coord):
    """The reference's (GSPMD's) block of each dim at mesh coordinate
    ``coord``: a dim over axes (a1, a2, ...) is split major to minor in
    the spec's order."""
    out = []
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str)
                                         else entry)
        idx, n = 0, 1
        for ax in axes:
            idx = idx * sizes[ax] + coord[ax]
            n *= sizes[ax]
        out.append(slice(idx * dim // n, (idx + 1) * dim // n))
    return tuple(out)


SPECS = [(("pod", "data"), None), (("pod", "data", "model"), None),
         ("data", "model"), (("model", "data"), None),
         (("model", "pod"), "data")]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_local_shard_is_the_references_slice(world, spec):
    """At sampled coordinates of a fake (2, 16, 16) world the local shard
    of ``distribute_tensor`` over :func:`sh.placements` holds the
    reference's slice of the tensor, also where the spec lists a dim's
    axes against the mesh's order (``_StridedShard``)."""
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sizes = {"pod": 2, "data": 16, "model": 16}
    shape = (1024, 64)
    full = torch.arange(1024 * 64).reshape(shape)
    for rank in (0, 1, 17, 255, 300, 511):
        dist.init_process_group("fake", rank=rank, world_size=512,
                                store=FakeStore())
        mesh = init_device_mesh("cpu", (2, 16, 16),
                                mesh_dim_names=("pod", "data", "model"))
        coord = dict(zip(("pod", "data", "model"), mesh.get_coordinate()))
        local = distribute_tensor(full, mesh, sh.placements(spec, mesh),
                                  src_data_rank=None).to_local()
        assert torch.equal(local, full[_jax_slice(spec, shape, sizes,
                                                  coord)]), (rank, coord)
        dist.destroy_process_group()


def test_shard_act_is_a_no_op_outside_a_context():
    x = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(0))
    assert shard_act(x, ("batch", "act_seq", "act_embed")) is x
    with pytest.raises(ValueError):
        with activation_sharding(lambda lg, s: None):
            shard_act(x, ("batch",))


B, S = 2, 16


def _smoke(arch):
    """The SMOKE config, seeded weights and a (B, S) token batch."""
    cfg = configs.get_smoke(arch)
    params = materialize(torch.Generator().manual_seed(0),
                         api.param_defs(cfg))
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)))}
    return cfg, params, batch


def _whole(x):
    return x.full_tensor() if type(x).__name__ == "DTensor" else x


@pytest.mark.parametrize("arch", ["granite_3_2b", "granite_moe_1b_a400m",
                                  "mamba2_130m", "zamba2_2_7b"])
def test_world1_forward_equals_unsharded(world, arch):
    """The dense, MoE, SSM and hybrid smoke loss forwards through a
    one-rank ``gloo`` mesh under the activation context equal the
    unsharded ones bitwise, and stay DTensors throughout."""
    cfg, params, batch = _smoke(arch)
    step = StepConfig(remat=False, loss_chunk=8)
    want = api.loss_fn(params, batch, cfg, step)
    mesh = make_host_mesh(device="cpu")
    rules = sh.TRAIN_RULES
    sp = steps.place(params, sh.sharding_tree(api.param_defs(cfg), rules,
                                              mesh))
    sb = steps.place(batch, steps._batch_shardings(
        cfg, WorkloadShape("t", S, B, "train"), mesh, rules))
    with activation_sharding(steps._resolver(mesh, rules)):
        got = api.loss_fn(sp, sb, cfg, step)
    assert type(got).__name__ == "DTensor"
    assert torch.equal(_whole(got), want)


@pytest.mark.parametrize("arch", ["granite_3_2b", "zamba2_2_7b"])
def test_world1_step_bundles_equal_meshless(world, arch):
    """``build_step`` train (two steps), prefill and decode through a
    one-rank mesh equal the ``mesh=None`` bundles bitwise: metrics,
    updated parameters, logits and caches."""
    cfg, params, batch = _smoke(arch)
    mesh = make_host_mesh(device="cpu")
    out = {}
    for m in (None, mesh):
        p = unflatten({k: v.clone() for k, v in flatten(params).items()})
        opt = adamw_init(api.param_defs(cfg), "cpu")
        train = steps.build_step(cfg, WorkloadShape("t", S, B, "train"), m,
                                 step_cfg=StepConfig(loss_chunk=8))
        fn = train.jitted()
        metrics = []
        for i in range(2):
            p, opt, mt = fn(p, opt, batch, i)
            metrics.append({k: _whole(v) for k, v in mt.items()})
        pre = steps.build_step(cfg, WorkloadShape("p", S, B, "prefill"), m)
        logits, cache = pre.jitted()(params, batch)
        dec = steps.build_step(cfg, WorkloadShape("d", S + 1, B, "decode"),
                               m)
        cache = api.extend_cache(_tree_whole(cache), 1)
        nxt = {"tokens": _whole(logits)[:, -1:, :cfg.vocab_size].argmax(-1)}
        dlog, dcache = dec.jitted()(params, nxt, cache, S)
        out[m is None] = (metrics, {k: _whole(v) for k, v in
                                    flatten(p).items()},
                          _whole(logits), _whole(dlog),
                          {k: _whole(v) for k, v in
                           flatten(dcache).items()})
    (m0, p0, l0, d0, c0), (m1, p1, l1, d1, c1) = out[True], out[False]
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a), (a, b)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert torch.equal(l0, l1) and torch.equal(d0, d1)
    assert all(torch.equal(c0[k], c1[k]) for k in c0)


def _tree_whole(tree):
    if isinstance(tree, dict):
        return {k: _tree_whole(v) for k, v in tree.items()}
    return _whole(tree)


def test_train_launcher_runs_through_the_host_mesh(world):
    """``launch.train.train`` builds on the host mesh (DTensors at world
    size 1) and gives the losses of the meshless bundle run by hand on
    the same weights and batches."""
    from repro_torch.launch.train import train
    got = train("mamba2_130m", steps=2, batch=2, seq=16, device="cpu",
                log_every=100)
    import torch.distributed as dist
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    cfg = configs.get_smoke("mamba2_130m")
    defs = api.param_defs(cfg)
    p = materialize(torch.Generator().manual_seed(0), defs)
    opt = adamw_init(defs, "cpu")
    bundle = steps.build_train_step(
        cfg, WorkloadShape("custom", 16, 2, "train"),
        step_cfg=StepConfig(remat=True, loss_chunk=16), peak_lr=3e-3,
        total_steps=2)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size), 2, 16,
                       device="cpu")
    want = []
    for i in range(2):
        p, opt, mt = bundle.fn(p, opt, data.batch_at(i), i)
        want.append(float(mt["loss"]))
    assert got["losses"] == want


def test_local_top_k_and_cumsum_reduce_a_partial_input(world):
    """At a ``gloo`` world of 1 a ``Partial`` DTensor (one rank's share
    of a sum, as a router's logits would be after a contraction over a
    split dim) goes through the local top-k and cumsum reduced first: the
    values and indices equal torch's on the summed tensor (exactly, one
    rank) and carry no ``Partial`` placement."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.distributed.actctx import cumsum, topk
    mesh = make_host_mesh(device="cpu")
    full = torch.randn(4, 8, generator=torch.Generator().manual_seed(2))
    part = DTensor.from_local(full, mesh, [Partial(), Replicate()],
                              run_check=False)
    values, index = topk(part, 3)
    summed = cumsum(part, 1)
    ref = torch.topk(full, 3)
    assert torch.equal(values.to_local(), ref.values)
    assert torch.equal(index.to_local(), ref.indices)
    assert torch.equal(summed.to_local(), torch.cumsum(full, 1))
    for t in (values, index, summed):
        assert all(isinstance(p, Replicate) for p in t.placements), \
            t.placements


def test_sharded_batch_rows_follow_the_rule(world):
    """On a fake (16, 16) world each rank makes its rows of the batch
    (its block of 256 / 16 rows, all columns), from draws seeded by
    (seed, step, first row): the reference's per-shard draws, fed to
    ``markov_tokens``, give the reference's shard tokens."""
    pipe = SyntheticLM(DataConfig(vocab_size=512, seed=3), 256, 16,
                       device="cpu")
    mesh = make_production_mesh()
    spec = sh.logical_to_spec(("batch", None), (256, 16), sh.TRAIN_RULES,
                              mesh)
    out = make_batch_sharded(pipe, 7, mesh, spec)["tokens"]
    assert tuple(out.shape) == (256, 16)
    local = out.to_local()
    assert tuple(local.shape) == (16, 16)       # rank 0: rows 0..15
    want = markov_tokens(pipe._succ, *pipe.draws(7, 16, start=0))
    assert np.array_equal(local.numpy(), want)
    # the reference's draws for the shard starting at row 32, through the
    # port's recurrence, give the reference's shard tokens
    ref = JaxSyntheticLM(JaxDataConfig(vocab_size=512, seed=3), 256, 16)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(3), 7), 32)
    k_init, k_noise, k_mask = jax.random.split(key, 3)
    first = np.asarray(jax.random.randint(k_init, (16, 1), 0, 512))
    noise = np.asarray(jax.random.randint(k_noise, (16, 16), 0, 512))
    follow = np.asarray(jax.random.bernoulli(k_mask, 0.8, (16, 16)))
    assert np.array_equal(markov_tokens(np.asarray(ref._succ), first, noise,
                                        follow),
                          np.asarray(ref._tokens(key, 16)))


WORLD2_ARCHS = ("granite_3_2b", "mamba2_130m", "granite_moe_1b_a400m",
                "zamba2_2_7b", "whisper_base", "llama_3_2_vision_11b")
WORLD2 = f"ARCHS = {WORLD2_ARCHS!r}" + r"""
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
rank, port, shape = int(sys.argv[1]), sys.argv[2], eval(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
from repro_torch import configs
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.actctx import activation_sharding
from repro_torch.models import api
from repro_torch.models.config import WorkloadShape, input_specs
from repro_torch.models.params import flatten, materialize
from repro_torch.models.transformer import StepConfig
from repro_torch.train import steps
torch.manual_seed(0)
mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
rel = {}
for arch in ARCHS:
    cfg = configs.get_smoke(arch)
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": "float32"})
    defs = api.param_defs(cfg)
    params = materialize(torch.Generator().manual_seed(0), defs)
    gen = torch.Generator().manual_seed(1)
    wshape = WorkloadShape("t", 16, 4, "train")
    batch = {name: torch.randint(0, cfg.vocab_size, tuple(sds.shape),
                                 generator=gen)
             if not sds.dtype.is_floating_point
             else torch.randn(tuple(sds.shape), generator=gen)
             for name, sds in input_specs(cfg, wshape).items()}
    step = StepConfig(remat=True, loss_chunk=8)
    want_loss, want = api.loss_and_grads(params, batch, cfg, step)
    rules = sh.TRAIN_RULES
    sp = steps.place(params, sh.sharding_tree(defs, rules, mesh))
    sb = steps.place(batch, steps._batch_shardings(cfg, wshape, mesh,
                                                   rules))
    with activation_sharding(steps._resolver(mesh, rules)):
        loss, grads = api.loss_and_grads(sp, sb, cfg, step)
    got = {k: v.full_tensor() for k, v in flatten(grads).items()}
    scale = max(float(v.abs().max()) for v in flatten(want).values())
    rel[arch] = {"loss": abs(float(loss.full_tensor()) / float(want_loss)
                             - 1.0),
                 "grad": max(float((got[k] - v).abs().max())
                             for k, v in flatten(want).items()) / scale}
# the router's top-k of a partial sum (each rank holding a share of the
# logits) is the top-k of the sum, not of one rank's share
from torch.distributed.tensor import DTensor, Partial, Replicate
from repro_torch.distributed.actctx import cumsum, topk
full = torch.randn(4, 8, generator=torch.Generator().manual_seed(2))
part = DTensor.from_local(full * (rank + 1) / 3, mesh,
                          [Partial() if n > 1 else Replicate()
                           for n in mesh.shape], run_check=False)
values, index = topk(part, 3)
ref = torch.topk(full, 3)
local_ops = {
    "topk": torch.allclose(values.full_tensor(), ref.values, rtol=1e-6)
    and torch.equal(index.full_tensor(), ref.indices)
    and all(isinstance(p, Replicate) for p in index.placements),
    "cumsum": torch.allclose(cumsum(part, 1).full_tensor(),
                             torch.cumsum(full, 1), rtol=1e-6)}
if rank == 0:
    print(json.dumps({"rel": rel, "local_ops": local_ops}))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)],
                         ids=["data2", "model2"])
def test_sharded_loss_and_grads_match_at_world_two(shape):
    """Two ``gloo`` ranks on the CPU, the batch split over ``data`` or the
    heads, MLP, expert, vocab and SSM inner dims over ``model`` (the
    planned einsums, the partial-sum gradients, the MoE router's top-k,
    the vocab-split loss): the float32 SMOKE losses and gradients of one
    config of each family (dense, SSM, MoE, hybrid, enc-dec, VLM) equal
    the meshless ones to 1e-5 relative (another summation order across
    the two ranks; gradients relative to the largest gradient element).
    The local top-k and cumsum of a ``Partial`` input equal the ops on its
    sum to 1e-6 relative (the indices exactly)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", WORLD2, str(r),
                               str(port), repr(shape)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][1][-3000:]
    out = json.loads(outs[0][0].strip().splitlines()[-1])
    assert out["local_ops"] == {"topk": True, "cumsum": True}
    rel = out["rel"]
    assert tuple(rel) == WORLD2_ARCHS
    for arch, err in rel.items():
        assert err["loss"] <= 1e-5 and err["grad"] <= 1e-5, (arch, err)
