"""The port's SSM slice against the JAX package's: the Mamba2 layer
(``ssd_forward``, ``ssd_decode``), and the ``ssm`` (mamba2) and
``hybrid`` (zamba2) families' loss and gradients, prefill and decode,
on the JAX package's materialised weights and the same numpy tokens.

Everything here is float32. Tolerances: the layer outputs and states at
rtol = atol = 1e-5 (two frameworks' einsums and chunk scans summed in
different orders); prefill continuing decode at 1e-4, the bound of
``tests/test_ssd.py::test_prefill_state_continues_decode`` (a chunked
scan against a sequential recurrence); the loss and gradients at the
model tests' LOSS_RTOL / GRAD_TOL (``tests/test_torch_models.py``);
prefill and decode logits and caches at rtol = atol = 1e-5."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.models import api as jax_api
from repro.models import params as jax_params_lib
from repro.models import ssd as jax_ssd
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.transformer import StepConfig as JaxStepConfig
from repro.models.workloads import build_workload as jax_build_workload
from repro_torch import configs
from repro_torch.bench import common
from repro_torch.core import Direction, EvaluationSettings, Tuner
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import api, ssd
from repro_torch.models.config import ModelConfig, PREFILL_32K
from repro_torch.models.params import from_numpy
from repro_torch.models.transformer import StepConfig
from repro_torch.models.workloads import (build_workload, step_flops,
                                          train_step, workload_flops)

from test_torch_models import _check, _flatten

TOL = dict(rtol=1e-5, atol=1e-5)
CONTINUE_TOL = dict(rtol=1e-4, atol=1e-4)        # tests/test_ssd.py
SSM_ARCHS = ["mamba2_130m", "zamba2_2_7b"]


def _tiny(cls, chunk=8):
    """tests/test_ssd.py's layer config, in either package."""
    return cls(name="t", family="ssm", n_layers=1, d_model=32, n_heads=4,
               n_kv_heads=4, d_ff=0, vocab_size=64, ssm_state=16,
               ssm_head_dim=8, ssm_chunk=chunk, dtype="float32")


def _layer_params(chunk=8):
    p = jax_params_lib.materialize(jax.random.PRNGKey(0),
                                   jax_ssd.ssd_defs(_tiny(JaxModelConfig,
                                                          chunk)))
    p = jax.tree.map(np.asarray, p)
    return p, from_numpy(p, device="cpu")


def _u(seed, b, s, d=32):
    return (np.random.default_rng(seed).standard_normal((b, s, d)) * 0.5
            ).astype(np.float32)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else
            (v.detach().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v)) for k, v in tree.items()}


def _close_trees(got: dict, want: dict, tol) -> None:
    want = dict(_flatten(_np_tree(want)))
    got = dict(_flatten(_np_tree(got)))
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        np.testing.assert_allclose(x.astype(np.float32),
                                   want[path].astype(np.float32),
                                   err_msg=path, **tol)


@pytest.mark.parametrize("s,chunk", [(32, 8), (24, 16), (30, 8)],
                         ids=["chunks", "gcd-8", "gcd-2"])
@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_forward_matches_the_reference(s, chunk, return_state):
    """S = 24 with chunk 16 and S = 30 with chunk 8 take the gcd rule
    (Q = 8 and Q = 2)."""
    jp, tp = _layer_params(chunk)
    u = _u(s, 2, s)
    want = jax_ssd.ssd_forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(u),
                               _tiny(JaxModelConfig, chunk),
                               return_state=return_state)
    got = ssd.ssd_forward(tp, torch.from_numpy(u), _tiny(ModelConfig, chunk),
                          return_state=return_state)
    if return_state:
        _close_trees({"y": got[0], **got[1]}, {"y": want[0], **want[1]}, TOL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssd_decode_matches_the_reference():
    jp, tp = _layer_params()
    cfg, jcfg = _tiny(ModelConfig), _tiny(JaxModelConfig)
    rng = np.random.default_rng(7)
    cache = {"ssm": rng.standard_normal((2, 8, 8, 16)).astype(np.float32),
             "conv": rng.standard_normal((2, 3, 96)).astype(np.float32)}
    u = _u(8, 2, 1)
    y_want, c_want = jax_ssd.ssd_decode(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(u),
        jax.tree.map(jnp.asarray, cache), jcfg)
    y_got, c_got = ssd.ssd_decode(tp, torch.from_numpy(u),
                                  from_numpy(cache, device="cpu"), cfg)
    _close_trees({"y": y_got, **c_got}, {"y": y_want, **c_want}, TOL)
    assert ssd.ssm_cache_shapes(cfg, 3, 2) == {
        "ssm": ssd.ShapeDtype(torch.Size((3, 2, 8, 8, 16)), torch.float32),
        "conv": ssd.ShapeDtype(torch.Size((3, 2, 3, 96)), torch.float32)}


def test_prefill_state_continues_decode():
    """The chunk scan's output and final state against the sequential
    recurrence of ``ssd_decode``, an independent implementation."""
    _, tp = _layer_params()
    cfg = _tiny(ModelConfig)
    u = torch.from_numpy(_u(3, 2, 24))
    u_extra = torch.from_numpy(_u(4, 2, 1))
    _, cache = ssd.ssd_forward(tp, u, cfg, return_state=True)
    y_dec, _ = ssd.ssd_decode(tp, u_extra, cache, cfg)
    full = torch.cat([u, u_extra], dim=1)
    y_ref = ssd.ssd_reference_scan(tp, full, cfg)
    torch.testing.assert_close(y_dec, y_ref[:, -1:], **CONTINUE_TOL)
    torch.testing.assert_close(ssd.ssd_forward(tp, full, cfg), y_ref,
                               **CONTINUE_TOL)


def _jax_params(cfg):
    return jax.tree.map(np.asarray, jax_params_lib.materialize(
        jax.random.PRNGKey(0), jax_api.param_defs(cfg)))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(arch: str, use_flash: bool):
    """The SMOKE config's weights, tokens, and JAX ``value_and_grad`` of
    its loss with remat off. Remat recomputes the same math, so one
    compile per (arch, use_flash) serves both of the port's remat cases."""
    ref_cfg = jax_configs.get_smoke(arch)
    params = _jax_params(ref_cfg)
    tokens = _tokens(ref_cfg, 2, 32, 11)
    knobs = JaxStepConfig(use_flash=use_flash, flash_block_q=64,
                          flash_block_k=64, remat=False)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_api.loss_fn(
        p, {"tokens": jnp.asarray(tokens)}, ref_cfg, knobs)))(
        jax.tree.map(jnp.asarray, params))
    return params, tokens, float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("arch,use_flash",
                         [("mamba2_130m", 0), ("zamba2_2_7b", 0),
                          ("zamba2_2_7b", 1)],
                         ids=["mamba2-smoke", "zamba2-smoke",
                              "zamba2-smoke-flash"])
@pytest.mark.parametrize("remat", [0, 1])
def test_loss_and_gradients_match_the_reference(arch, use_flash, remat):
    params, tokens, ref_loss, ref_grads = _reference_loss_and_grads(
        arch, bool(use_flash))
    loss, grads = train_step(from_numpy(params, device="cpu"),
                             {"tokens": torch.from_numpy(tokens)},
                             cfg=configs.get_smoke(arch),
                             step=StepConfig(use_flash=bool(use_flash),
                                             flash_block_q=64,
                                             flash_block_k=64,
                                             remat=bool(remat)))
    _check(loss, grads, ref_loss, ref_grads)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_matches_the_reference(arch):
    ref_cfg = jax_configs.get_smoke(arch)
    params = _jax_params(ref_cfg)
    tokens = _tokens(ref_cfg, 2, 24, 12)
    want_logits, want_cache = jax.jit(lambda p, t: jax_api.prefill_fn(
        p, {"tokens": t}, ref_cfg, JaxStepConfig(remat=False)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens))
    logits, cache = api.prefill_fn(from_numpy(params, device="cpu"),
                                   {"tokens": torch.from_numpy(tokens)},
                                   configs.get_smoke(arch),
                                   StepConfig(remat=False))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **TOL)
    _close_trees(cache, want_cache, TOL)
    if arch == "zamba2_2_7b":
        grown = api.extend_cache(cache, 5)
        assert grown["attn"]["k"].shape[-2] == 24 + 5
        assert (grown["attn"]["pos"][..., 24:] == -1).all()
        assert torch.equal(grown["ssm"], cache["ssm"])


def test_mamba2_decode_matches_the_reference():
    ref_cfg = jax_configs.get_smoke("mamba2_130m")
    cfg = configs.get_smoke("mamba2_130m")
    params = _jax_params(ref_cfg)
    rng = np.random.default_rng(13)
    cache = {"ssm": rng.standard_normal((2, 2, 8, 16, 16)).astype(
        np.float32),
        "conv": rng.standard_normal((2, 2, 3, 160)).astype(np.float32)}
    tokens = _tokens(ref_cfg, 2, 1, 14)
    want = jax_api.decode_fn(jax.tree.map(jnp.asarray, params),
                             {"tokens": jnp.asarray(tokens)},
                             jax.tree.map(jnp.asarray, cache), jnp.int32(3),
                             ref_cfg, JaxStepConfig(remat=False))
    got = api.decode_fn(from_numpy(params, device="cpu"),
                        {"tokens": torch.from_numpy(tokens)},
                        from_numpy(cache, device="cpu"), 3, cfg,
                        StepConfig(remat=False))
    _close_trees({"logits": got[0], **got[1]},
                 {"logits": want[0], **want[1]}, TOL)
    shape = PREFILL_32K
    assert {k: tuple(v.shape) for k, v in api.cache_shapes(
        cfg, shape).items()} == {k: v.shape for k, v in jax_api.cache_shapes(
            ref_cfg, shape).items()}
    zeros = api.cache_init(cfg, shape, device="meta")
    assert zeros["conv"].shape == (2, 32, 3, 160)


@pytest.mark.parametrize("name,arch", [("prefill_step", "mamba2_130m"),
                                       ("prefill_step", "zamba2_2_7b"),
                                       ("decode_step", "mamba2_130m"),
                                       ("prefill_step", None),
                                       ("decode_step", None),
                                       ("decode_step", "zamba2_2_7b")])
def test_workload_fed_the_reference_args_gives_the_reference_result(
        name, arch):
    ref = jax_build_workload(name, arch)
    want = jax.jit(ref.fn)(*ref.args)
    args = jax.tree.map(np.asarray, ref.args)
    ours = build_workload(name, arch, device="cpu")
    assert ours.kind == ref.kind
    assert dataclasses.astuple(ours.shape) == dataclasses.astuple(ref.shape)
    assert [tuple(a.shape) for a in jax.tree.leaves(args[1])] == \
        [tuple(a.shape) for a in ours.args[1].values()]
    fed = (from_numpy(args[0], device="cpu"),
           {"tokens": torch.from_numpy(np.array(args[1]["tokens"]))})
    if name == "decode_step":
        fed += (from_numpy(args[2], device="cpu"), int(args[3]))
    logits, cache = ours.fn(*fed)
    _close_trees({"logits": logits, **cache},
                 {"logits": want[0], **want[1]}, TOL)
    assert workload_flops(ours) == step_flops(
        ours.cfg, ours.shape.global_batch, ours.shape.seq_len,
        ours.kind) > 0


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_decode_step_has_the_reference_cache_keys(arch):
    """Every family builds its ``decode_step`` workload, with the
    reference's cache keys."""
    w = build_workload("decode_step", arch, device="cpu", seq_len=16)
    assert set(w.args[2]) == set(jax_api.cache_shapes(
        jax_configs.get_smoke(arch), w.shape))


def test_host_prefill_session_tunes_every_config_without_the_kernels():
    reset_launch_counts()
    settings = EvaluationSettings(max_invocations=2, max_iterations=5,
                                  max_time_s=0.2,
                                  direction=Direction.MAXIMIZE)
    bench = common.model_step_family("prefill_step", "mamba2_130m",
                                     batch_size=2, seq_len=32, device="cpu")
    assert bench.__name__ == "model_step_prefill_step"
    result = Tuner(common.model_step_space(True), settings).tune(bench)
    assert len(result.trials) == 8
    assert np.isfinite(result.best_score) and result.best_score > 0
    assert launch_counts() == {"matmul": 0, "triad": 0,
                               "flash_attention": 0, "ssd_chunk_scan": 0}
