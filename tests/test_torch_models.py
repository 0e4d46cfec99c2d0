"""The port's model stack against the JAX package's: the ten configs
field by field, parameter counts, the numpy bridge of the parameters,
and the dense train step's loss and gradients on the same weights and
tokens (the JAX package's materialised weights carried into the port).

Tolerances (all configs here are float32): the loss to 1e-5 relative;
gradient leaves to rtol 1e-4, atol 1e-6. The two frameworks sum the
einsums and the chunked loss in different orders; the JAX flash path
(Pallas in interpret mode) and the port's plain path differ the same
way."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro.models.config as jax_config
from repro.models import api as jax_api
from repro.models.params import materialize as jax_materialize
from repro.models.transformer import StepConfig as JaxStepConfig
from repro.models.workloads import TINY_CONFIG as JAX_TINY
from repro.models.workloads import build_workload as jax_build_workload
from repro_torch import configs
from repro_torch.models import api, config
from repro_torch.models.params import (ParamDef, from_numpy, materialize,
                                       n_params, to_numpy)
from repro_torch.models.transformer import StepConfig
from repro_torch.models.workloads import (TINY_CONFIG, WORKLOAD_NAMES,
                                          build_workload, train_step)

LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
DENSE = [a for a in configs.ARCH_IDS if configs.get(a).family == "dense"]
PROPERTIES = ("head_dim_", "vocab_padded", "d_inner", "ssm_heads",
              "supports_long_context", "has_decoder")


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    for ours, theirs in ((configs.get(arch), jax_configs.get(arch)),
                         (configs.get_smoke(arch),
                          jax_configs.get_smoke(arch))):
        assert _fields(ours) == _fields(theirs)
        for prop in PROPERTIES:
            assert getattr(ours, prop) == getattr(theirs, prop), prop
        assert ours.tdtype == (torch.bfloat16 if theirs.jdtype == jnp.bfloat16
                               else torch.float32)
        for name, shape in config.SHAPES.items():
            ref_shape = jax_config.SHAPES[name]
            assert dataclasses.astuple(shape) == \
                dataclasses.astuple(ref_shape)
            assert config.cache_len(ours, shape) == \
                jax_config.cache_len(theirs, ref_shape)
            assert config.cell_is_applicable(ours, shape) == \
                jax_config.cell_is_applicable(theirs, ref_shape)


def test_registry_behaves_like_the_reference():
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert configs.canonical("granite-3-2b") == "granite_3_2b"
    assert configs.canonical("llama-3.2-vision-11b") == \
        jax_configs.canonical("llama-3.2-vision-11b")
    with pytest.raises(KeyError):
        configs.get("gpt-5")
    assert _fields(TINY_CONFIG) == _fields(JAX_TINY)


@pytest.mark.parametrize("arch", DENSE + ["mamba2_130m", "zamba2_2_7b"])
def test_dense_param_counts_equal_the_reference(arch):
    assert configs.get(arch).n_params() == jax_configs.get(arch).n_params()
    assert configs.get_smoke(arch).n_params() == \
        jax_configs.get_smoke(arch).n_params()


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "whisper_base",
                                  "granite_moe_1b_a400m",
                                  "llama_3_2_vision_11b"])
def test_unported_families_raise_naming_the_roadmap(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        configs.get_smoke(arch).n_params()


#: the families still to port, by a SMOKE arch, and their ROADMAP.md entry
UNPORTED_SERVING = (("granite_moe_1b_a400m", "MoE"),
                    ("llama_3_2_vision_11b", "VLM"),
                    ("whisper_base", "enc-dec"))


def test_serving_entry_points_raise_naming_the_roadmap():
    """The MoE, VLM and enc-dec families' serving entry points raise,
    naming their ROADMAP.md entries (the dense, ssm and hybrid families'
    are ported: tests/test_torch_serving.py)."""
    for arch, entry in UNPORTED_SERVING:
        cfg = configs.get_smoke(arch)
        roadmap = re.escape(f"(ROADMAP.md, 'Still to port': {entry})")
        with pytest.raises(NotImplementedError, match=roadmap):
            api.prefill_fn({}, {}, cfg, StepConfig())
        with pytest.raises(NotImplementedError, match=roadmap):
            api.decode_fn({}, {"tokens": None}, {}, 0, cfg, StepConfig())
        with pytest.raises(NotImplementedError, match=roadmap):
            api.cache_shapes(cfg, config.DECODE_32K)
        with pytest.raises(NotImplementedError, match=roadmap):
            api.cache_init(cfg, config.DECODE_32K, device="meta")
    assert WORKLOAD_NAMES == ("train_step", "prefill_step", "decode_step",
                              "dgemm")


def _jax_params(cfg):
    return jax.tree.map(np.asarray, jax_materialize(jax.random.PRNGKey(0),
                                                    jax_api.param_defs(cfg)))


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def test_param_tree_matches_the_reference_layout():
    ours = dict(_flatten(api.param_defs(TINY_CONFIG)))
    theirs = dict(_flatten(_jax_params(JAX_TINY)))
    assert sorted(ours) == sorted(theirs)   # jax.tree sorts dict keys
    for path, d in ours.items():
        assert d.shape == theirs[path].shape, path
        assert d.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_numpy_round_trip_is_exact(dtype):
    gen = torch.Generator().manual_seed(3)
    tree = materialize(gen, {"a": {"w": ParamDef((8, 5), ("x", "y"),
                                                 dtype=dtype)},
                             "n": ParamDef((5,), ("x",), init="ones",
                                           dtype=dtype)})
    back = from_numpy(to_numpy(tree), device="cpu", dtype=dtype)
    for (pa, x), (pb, y) in zip(_flatten(tree), _flatten(back)):
        assert pa == pb and x.dtype == y.dtype == dtype
        assert torch.equal(x, y)


def test_materialize_follows_the_reference_init_rules():
    defs = api.param_defs(dataclasses.replace(TINY_CONFIG, n_layers=2,
                                              d_model=256, d_ff=512))
    params = materialize(torch.Generator().manual_seed(0), defs)
    again = materialize(torch.Generator().manual_seed(0), defs)
    other = materialize(torch.Generator().manual_seed(1), defs)
    for (path, x), (_, y), (_, z) in zip(_flatten(params), _flatten(again),
                                         _flatten(other)):
        assert torch.equal(x, y), path            # seeded by root + path
        d = dict(_flatten(defs))[path]
        if d.init == "ones":
            assert torch.equal(x, torch.ones_like(x))
            continue
        assert not torch.equal(x, z), path
        want = d.scale if d.scale is not None else \
            float(np.prod(d.shape[:-1])) ** -0.5
        assert abs(float(x.float().std()) / want - 1.0) < 0.05, path
    assert n_params(defs) == sum(x.numel() for _, x in _flatten(params))


def _jax_loss_and_grads(cfg, params, tokens, step):
    fn = jax.jit(jax.value_and_grad(
        lambda p: jax_api.loss_fn(p, {"tokens": tokens}, cfg, step)))
    loss, grads = fn(jax.tree.map(jnp.asarray, params))
    return float(loss), jax.tree.map(np.asarray, grads)


def _check(loss, grads, ref_loss, ref_grads) -> None:
    assert abs(float(loss) / ref_loss - 1.0) < LOSS_RTOL
    ref = dict(_flatten(ref_grads))
    got = dict(_flatten(grads))
    assert sorted(got) == sorted(ref)
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[path], err_msg=path,
                                   **GRAD_TOL)


@pytest.mark.parametrize("arch", [None, "granite_3_2b", "gemma_2b"],
                         ids=["tiny", "granite-smoke", "gemma-smoke"])
@pytest.mark.parametrize("seq", [16, 64])
@pytest.mark.parametrize("use_flash", [0, 1])
@pytest.mark.parametrize("remat", [0, 1])
def test_loss_and_gradients_match_the_reference(arch, seq, use_flash, remat):
    ours_cfg = TINY_CONFIG if arch is None else configs.get_smoke(arch)
    ref_cfg = JAX_TINY if arch is None else jax_configs.get_smoke(arch)
    params = _jax_params(ref_cfg)
    tokens = np.random.default_rng(seq).integers(
        0, ref_cfg.vocab_size, (2, seq)).astype(np.int32)
    knobs = dict(use_flash=bool(use_flash), flash_block_q=64,
                 flash_block_k=64, remat=bool(remat))
    ref_loss, ref_grads = _jax_loss_and_grads(ref_cfg, params,
                                              jnp.asarray(tokens),
                                              JaxStepConfig(**knobs))
    loss, grads = train_step(from_numpy(params, device="cpu"),
                             {"tokens": torch.from_numpy(tokens)},
                             cfg=ours_cfg, step=StepConfig(**knobs))
    _check(loss, grads, ref_loss, ref_grads)


def test_workload_fed_the_reference_args_gives_the_reference_result():
    ref = jax_build_workload("train_step")
    ref_loss, ref_grads = jax.jit(ref.fn)(*ref.args)
    params, batch = jax.tree.map(np.asarray, ref.args)
    ours = build_workload("train_step", device="cpu")
    assert ours.step == StepConfig(remat=False) and ours.cfg == TINY_CONFIG
    assert batch["tokens"].shape == tuple(ours.args[1]["tokens"].shape)
    loss, grads = ours.fn(from_numpy(params, device="cpu"),
                          {"tokens": torch.tensor(batch["tokens"])})
    _check(loss, grads, float(ref_loss), jax.tree.map(np.asarray, ref_grads))


def test_workload_arch_takes_a_name_or_a_config():
    smoke = build_workload("train_step", "granite-3-2b", device="cpu",
                           seq_len=16)
    assert smoke.cfg == configs.get_smoke("granite_3_2b")
    cut = dataclasses.replace(configs.get("granite_3_2b"), n_layers=1,
                              vocab_size=512)
    w = build_workload("train_step", cut, device="cpu", batch_size=1,
                       seq_len=8)
    assert w.cfg is cut and w.args[0]["layers"]["ln1"].shape == (1, 2048)
    assert w.args[1]["tokens"].shape == (1, 8)
    dgemm = build_workload("dgemm", m=32, n=16, k=8, device="cpu")
    assert dgemm.declared_flops == 2.0 * 32 * 16 * 8
    assert dgemm.fn(*dgemm.args).shape == (32, 16)
