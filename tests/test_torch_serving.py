"""The port's serving slice against the JAX package's: ``attention_decode``
on a position-tagged KV cache (GQA, MQA, a window, a rolling cache that
has wrapped), dense and hybrid ``prefill_fn`` and ``decode_fn``, decode
continuing prefill, the decode cache's shape trees, and the serving
launcher, on the JAX package's materialised weights and the same numpy
inputs.

Everything here is float32. Tolerances: outputs and caches against the
reference at rtol = atol = 1e-5 (two frameworks' einsums summed in
different orders); decode continuing prefill at CONTINUE_TOL (1e-4, the
bound of ``tests/test_ssd.py::test_prefill_state_continues_decode``:
attention over a cache against the masked full-sequence path, and for
zamba2 the SSD chunk scan against its sequential recurrence). Decode
writes the KV cache in place, so no cache here is fed to two decodes:
each comes fresh from ``from_numpy`` or ``extend_cache`` (a copy)."""

import dataclasses
import io
import runpy
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models import params as jax_params_lib
from repro.models.config import DECODE_32K as JAX_DECODE_32K
from repro.models.config import PREFILL_32K as JAX_PREFILL_32K
from repro.models.config import WorkloadShape as JaxWorkloadShape
from repro.models.transformer import StepConfig as JaxStepConfig
from repro_torch import configs
from repro_torch.launch.serve import generate, serve
from repro_torch.models import api, layers
from repro_torch.models.config import DECODE_32K, PREFILL_32K, WorkloadShape
from repro_torch.models.params import from_numpy
from repro_torch.models.transformer import StepConfig

from test_torch_ssm import _close_trees, _jax_params, _np_tree

TOL = dict(rtol=1e-5, atol=1e-5)
CONTINUE_TOL = dict(rtol=1e-4, atol=1e-4)        # tests/test_ssd.py
DENSE = ["granite_3_2b", "gemma_2b", "minicpm_2b", "command_r_plus_104b"]
STEP = dict(remat=False)


def _jax_tree(tree: dict) -> dict:
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# attention_decode
# ---------------------------------------------------------------------------


def _decode_inputs(cfg, length: int, pos: int, seed: int):
    """One layer's attention weights (the JAX package's), x (B=2, 1, D)
    and a cache of ``length`` slots holding the positions a cache would
    hold just before ``pos``: slot p % length for every p < pos, the
    latest one winning (a rolling cache that has wrapped when pos >
    length), -1 in the slots never written."""
    p = jax.tree.map(np.asarray, jax_params_lib.materialize(
        jax.random.PRNGKey(seed), jax_layers.attention_defs(cfg)))
    rng = np.random.default_rng(seed)
    b, hkv, dh = 2, cfg.n_kv_heads, cfg.head_dim_
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    tags = np.full((b, length), -1, np.int32)
    for q in range(pos):
        tags[:, q % length] = q
    cache = {"k": rng.standard_normal((b, hkv, length, dh)).astype(
        np.float32),
        "v": rng.standard_normal((b, hkv, length, dh)).astype(np.float32),
        "pos": tags}
    return p, x, cache


@pytest.mark.parametrize("arch,length,pos,window", [
    ("granite_3_2b", 24, 10, None),        # GQA, empty slots ahead
    ("gemma_2b", 24, 10, None),            # MQA, head_dim 32
    ("granite_3_2b", 24, 20, 8),           # a window inside a linear cache
    ("zamba2_2_7b", 16, 37, 16),           # rolling cache, wrapped twice
], ids=["gqa", "mqa", "window", "rolling"])
def test_attention_decode_matches_the_reference(arch, length, pos, window):
    ref_cfg = jax_configs.get_smoke(arch)
    cfg = configs.get_smoke(arch)
    p, x, cache = _decode_inputs(ref_cfg, length, pos, seed=length + pos)
    want_y, want_cache = jax_layers.attention_decode(
        _jax_tree(p), jnp.asarray(x), _jax_tree(cache), jnp.int32(pos),
        ref_cfg, window=window)
    assert int(np.asarray(want_cache["pos"])[0, pos % length]) == pos
    got = {}
    for kind, at in (("int", pos), ("tensor", torch.tensor(pos))):
        tc = from_numpy(cache, device="cpu")
        y, new = layers.attention_decode(from_numpy(p, device="cpu"),
                                         torch.from_numpy(x), tc, at, cfg,
                                         window=window)
        assert new is tc and all(new[k] is tc[k] for k in tc)   # in place
        _close_trees({"y": y, **new}, {"y": want_y, **want_cache}, TOL)
        got[kind] = (y, new)
    assert torch.equal(got["int"][0], got["tensor"][0])
    for key in ("k", "v", "pos"):
        assert torch.equal(got["int"][1][key], got["tensor"][1][key])


def test_decode_position_passes_a_tensor_through():
    pos = torch.tensor(7, dtype=torch.int32)
    assert layers.decode_position(pos, torch.device("cpu")) is pos
    made = layers.decode_position(7, torch.device("cpu"))
    assert made.dim() == 0 and int(made) == 7


# ---------------------------------------------------------------------------
# prefill_fn, decode_fn
# ---------------------------------------------------------------------------


def _tokens(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _jax_prefill(ref_cfg, params, tokens):
    return jax.jit(lambda p, t: jax_api.prefill_fn(
        p, {"tokens": t}, ref_cfg, JaxStepConfig(**STEP)))(
        _jax_tree(params), jnp.asarray(tokens))


def _jax_decoder(ref_cfg):
    return jax.jit(lambda p, t, c, pos: jax_api.decode_fn(
        p, {"tokens": t}, c, pos, ref_cfg, JaxStepConfig(**STEP)))


@pytest.mark.parametrize("arch", DENSE + ["zamba2_2_7b"])
def test_prefill_and_a_decode_step_match_the_reference(arch):
    ref_cfg = jax_configs.get_smoke(arch)
    cfg = configs.get_smoke(arch)
    params = _jax_params(ref_cfg)
    tokens = _tokens(ref_cfg, 2, 12, 21)
    nxt = _tokens(ref_cfg, 2, 1, 22)
    want_logits, want_cache = _jax_prefill(ref_cfg, params, tokens)
    ours = from_numpy(params, device="cpu")
    logits, cache = api.prefill_fn(ours, {"tokens": torch.from_numpy(tokens)},
                                   cfg, StepConfig(**STEP))
    _close_trees({"logits": logits, **cache},
                 {"logits": want_logits, **want_cache}, TOL)
    assert set(cache) == set(want_cache)
    assert tuple(cache["attn"]["k"].shape)[-2] == 12
    want = _jax_decoder(ref_cfg)(_jax_tree(params), jnp.asarray(nxt),
                                 jax_api.extend_cache(want_cache, 3),
                                 jnp.int32(12))
    got = api.decode_fn(ours, {"tokens": torch.from_numpy(nxt)},
                        api.extend_cache(cache, 3), 12, cfg,
                        StepConfig(**STEP))
    _close_trees({"logits": got[0], **got[1]},
                 {"logits": want[0], **want[1]}, TOL)
    assert (got[1]["attn"]["pos"][..., 12] == 12).all()
    assert (got[1]["attn"]["pos"][..., 13:] == -1).all()


@pytest.mark.parametrize("arch", DENSE + ["zamba2_2_7b"])
def test_teacher_forced_decode_continues_prefill(arch):
    """The port's counterpart of ``tests/test_models_smoke.py::
    test_prefill_decode_consistency``: a prefill of 8 tokens, grown by
    4 slots, then 4 teacher-forced decode steps give the last logits and
    every cache leaf of one prefill of the 12 tokens."""
    cfg = configs.get_smoke(arch)
    params = from_numpy(_jax_params(jax_configs.get_smoke(arch)),
                        device="cpu")
    tokens = torch.from_numpy(_tokens(cfg, 2, 12, 31))
    step = StepConfig(**STEP)
    logits, cache = api.prefill_fn(params, {"tokens": tokens[:, :8]}, cfg,
                                   step)
    cache = api.extend_cache(cache, 4)
    for t in range(8, 12):
        logits, cache = api.decode_fn(params, {"tokens": tokens[:, t:t + 1]},
                                      cache, t, cfg, step)
    want_logits, want = api.prefill_fn(params, {"tokens": tokens}, cfg, step)
    _close_trees({"logits": logits, **cache},
                 {"logits": want_logits, **want}, CONTINUE_TOL)


def test_zamba2_decodes_past_its_window_from_an_empty_cache():
    """zamba2 (window 16) decodes 40 tokens from ``cache_init``: its
    16-slot rolling cache wraps twice, and the window mask drops what the
    slots no longer hold. The last logits must be the port's prefill's
    of the 40 tokens, and every step's logits and the final cache the
    JAX package's decode."""
    ref_cfg = jax_configs.get_smoke("zamba2_2_7b")
    cfg = configs.get_smoke("zamba2_2_7b")
    assert cfg.window == 16
    params = _jax_params(ref_cfg)
    ours = from_numpy(params, device="cpu")
    tokens = _tokens(cfg, 2, 40, 41)
    shape = WorkloadShape("decode_40", 40, 2, "decode")
    cache = api.cache_init(cfg, shape, device="cpu")
    assert cache["attn"]["k"].shape[-2] == 16
    want_cache = jax_api.cache_init(
        ref_cfg, JaxWorkloadShape("decode_40", 40, 2, "decode"))
    decode = _jax_decoder(ref_cfg)
    jp = _jax_tree(params)
    step = StepConfig(**STEP)
    for t in range(40):
        logits, cache = api.decode_fn(
            ours, {"tokens": torch.from_numpy(tokens[:, t:t + 1])}, cache, t,
            cfg, step)
        want_logits, want_cache = decode(jp, jnp.asarray(tokens[:, t:t + 1]),
                                         want_cache, jnp.int32(t))
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                                   err_msg=f"step {t}", **TOL)
    _close_trees(cache, want_cache, TOL)
    assert sorted(cache["attn"]["pos"][0, 0].tolist()) == list(range(24, 40))
    full_logits, _ = api.prefill_fn(ours, {"tokens": torch.from_numpy(tokens)},
                                    cfg, step)
    np.testing.assert_allclose(logits.numpy(), full_logits.numpy(),
                               **CONTINUE_TOL)


# ---------------------------------------------------------------------------
# Cache trees
# ---------------------------------------------------------------------------


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


@pytest.mark.parametrize("arch", ["granite_3_2b", "gemma_2b", "zamba2_2_7b"])
@pytest.mark.parametrize("cell", ["decode_32k", "prefill_32k"])
def test_cache_trees_match_the_reference(arch, cell):
    shape, ref_shape = {"decode_32k": (DECODE_32K, JAX_DECODE_32K),
                        "prefill_32k": (PREFILL_32K, JAX_PREFILL_32K)}[cell]
    cfg, ref_cfg = configs.get(arch), jax_configs.get(arch)
    want = dict(_flatten_shapes(jax_api.cache_shapes(ref_cfg, ref_shape)))
    got = dict(_flatten_shapes(api.cache_shapes(cfg, shape)))
    assert got == {k: (tuple(s), _DTYPES[str(d)]) for k, (s, d) in
                   want.items()}
    zeros = api.cache_init(cfg, shape, device="meta")
    assert dict(_flatten_shapes(zeros)) == got
    if cfg.window is not None:               # zamba2: the window caps it
        assert got["/attn/k"][0][-2] == cfg.window


def _flatten_shapes(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten_shapes(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", (tuple(v.shape), v.dtype)


@pytest.mark.parametrize("arch", ["granite_3_2b", "zamba2_2_7b"])
def test_cache_init_equals_the_reference(arch):
    shape = WorkloadShape("decode_24", 24, 2, "decode")
    got = api.cache_init(configs.get_smoke(arch), shape, device="cpu")
    want = jax_api.cache_init(jax_configs.get_smoke(arch),
                              JaxWorkloadShape("decode_24", 24, 2, "decode"))
    _close_trees(got, want, dict(rtol=0, atol=0))
    assert got["attn"]["pos"].dtype == torch.int32
    assert (got["attn"]["pos"] == -1).all()


# ---------------------------------------------------------------------------
# The serving launcher
# ---------------------------------------------------------------------------


def test_serve_generates():
    """The counterpart of ``tests/test_system.py::test_serve_generates``."""
    r = serve("granite_3_2b", batch=2, prompt_len=16, gen=4, device="cpu")
    assert r["tokens"].shape == (2, 4)
    vocab = configs.get_smoke("granite_3_2b").vocab_size
    assert ((r["tokens"] >= 0) & (r["tokens"] < vocab)).all()
    assert r["prefill_s"] > 0 and r["decode_s_per_token"] > 0
    again = serve("granite_3_2b", batch=2, prompt_len=16, gen=4,
                  device="cpu")
    assert np.array_equal(r["tokens"], again["tokens"])   # seeded


@pytest.mark.parametrize("arch", ["granite_3_2b", "zamba2_2_7b"])
def test_greedy_loop_gives_the_reference_logits(arch):
    """Fed the JAX package's weights and prompt (drawn as its ``serve``
    draws them), the port's loop gives the reference loop's logits at
    every step, with the reference's greedy tokens forced into both, so
    that a near-tie cannot send them down different sequences."""
    ref_cfg = jax_configs.get_smoke(arch)
    cfg = configs.get_smoke(arch)
    batch, prompt_len, gen = 2, 16, 6
    params = jax_params_lib.materialize(jax.random.key(0),
                                        jax_api.param_defs(ref_cfg))
    prompt = jax.random.randint(jax.random.key(1), (batch, prompt_len), 0,
                                ref_cfg.vocab_size)
    logits, cache = _jax_prefill(ref_cfg, params, prompt)
    cache = jax_api.extend_cache(cache, gen)
    decode = _jax_decoder(ref_cfg)
    tokens = jnp.argmax(logits[:, -1:, :ref_cfg.vocab_size], axis=-1)
    want_tokens, want_logits = [tokens], [logits[:, -1:]]
    for t in range(gen - 1):
        logits, cache = decode(params, tokens, cache,
                               jnp.int32(prompt_len + t))
        tokens = jnp.argmax(logits[:, :, :ref_cfg.vocab_size], axis=-1)
        want_tokens.append(tokens)
        want_logits.append(logits)
    want_tokens = np.array(jnp.concatenate(want_tokens, axis=1))
    want_logits = np.asarray(jnp.concatenate(want_logits, axis=1))

    out = generate(from_numpy(jax.tree.map(np.asarray, params),
                              device="cpu"),
                   torch.from_numpy(np.array(prompt)), cfg, gen,
                   forced=torch.from_numpy(want_tokens))
    assert out["tokens"].dtype == torch.int32
    assert np.array_equal(out["tokens"].numpy(), want_tokens)
    np.testing.assert_allclose(out["logits"].numpy(), want_logits, **TOL)
    # where the reference's choice is clear, the port's argmax makes it
    top2 = np.sort(want_logits[..., :cfg.vocab_size], axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3
    ours = out["logits"][..., :cfg.vocab_size].argmax(-1).numpy()
    assert clear.any() and np.array_equal(ours[clear], want_tokens[clear])


def test_prefill_is_plain_and_decode_writes_the_cache_in_place():
    """Prefill takes the plain attention whatever ``use_flash`` says, as
    the reference does; a decode step writes the KV cache in place and
    returns the tensors it was given."""
    cfg = configs.get_smoke("granite_3_2b")
    step = dataclasses.replace(StepConfig(**STEP), use_flash=True)
    params = from_numpy(_jax_params(jax_configs.get_smoke("granite_3_2b")),
                        device="cpu")
    tokens = torch.from_numpy(_tokens(cfg, 2, 10, 51))
    logits, cache = api.prefill_fn(params, {"tokens": tokens}, cfg, step)
    plain_logits, _ = api.prefill_fn(params, {"tokens": tokens}, cfg,
                                     StepConfig(**STEP))
    assert torch.equal(logits, plain_logits)   # prefill is always plain
    grown = api.extend_cache(cache, 2)
    before = {k: v.data_ptr() for k, v in grown["attn"].items()}
    _, after = api.decode_fn(params, {"tokens": tokens[:, :1]}, grown, 10,
                             cfg, step)
    assert {k: v.data_ptr() for k, v in after["attn"].items()} == before
    assert _np_tree(after)["attn"]["pos"][0, 0, 10] == 10


def test_inference_runs_the_chunked_attention_without_checkpoints(
        monkeypatch):
    """A prefill long enough for the q-chunked attention (S >= 2048)
    checkpoints nothing without grad mode (a process's first checkpoint
    imports ``torch._dynamo``); with grad mode each chunk is
    checkpointed, and both give the same output."""
    calls = []

    def counting(fn, *args, **kw):
        calls.append(fn)
        return fn(*args)

    monkeypatch.setattr(layers, "checkpoint", counting)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 2048, 8, generator=gen)
    kv = torch.randn(1, 1, 2048, 8, generator=gen)
    with torch.no_grad():
        plain = layers._attend(q, kv, kv, causal=True, window=None)
    assert calls == []
    with torch.enable_grad():
        chunked = layers._attend(q, kv, kv, causal=True, window=None)
    assert len(calls) == 2048 // layers._Q_CHUNK
    assert torch.equal(plain, chunked)


def test_prefill_under_remat_checkpoints_each_layer(monkeypatch):
    """With grad mode and ``remat``, the dense prefill checkpoints each
    layer, as the reference wraps its body in ``jax.checkpoint``, and
    gives the logits, cache and weight gradients of the plain prefill."""
    calls = []

    def counting(fn, *args, **kw):
        calls.append(fn)
        return fn(*args)

    monkeypatch.setattr(layers, "checkpoint", counting)
    cfg = configs.get_smoke("granite_3_2b")
    params = from_numpy(_jax_params(jax_configs.get_smoke("granite_3_2b")),
                        device="cpu")
    tokens = torch.from_numpy(_tokens(cfg, 2, 10, 52))
    out = {}
    for remat in (False, True):
        leaf = params["layers"]["attn"]["wq"].detach().requires_grad_()
        tree = {**params, "layers": {**params["layers"], "attn": {
            **params["layers"]["attn"], "wq": leaf}}}
        logits, cache = api.prefill_fn(tree, {"tokens": tokens}, cfg,
                                       StepConfig(remat=remat))
        (grad,) = torch.autograd.grad(logits.square().sum(), leaf)
        out[remat] = (logits, cache, grad)
    assert len(calls) == cfg.n_layers
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    _close_trees(out[True][1], _np_tree(out[False][1]), TOL)
    torch.testing.assert_close(out[True][2], out[False][2], **TOL)


def test_serve_batched_example_runs_on_the_host(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve_batched", "--arch",
                                      "zamba2_2_7b", "--batch", "2",
                                      "--prompt-len", "8", "--gen", "3",
                                      "--device", "cpu"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        runpy.run_module("repro_torch.examples.serve_batched",
                         run_name="__main__")
    assert "[serve] generated token ids:" in buf.getvalue()
