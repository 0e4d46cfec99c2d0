"""The port's MoE, VLM and enc-dec families against the JAX package's:
granite-moe-1b-a400m, mixtral-8x22b, llama-3.2-vision-11b and
whisper-base at their SMOKE widths, on the JAX package's materialised
weights and the same numpy inputs (tokens, image embeddings, frames).
The parameter trees, ``loss_fn`` and its gradients, ``prefill_fn``,
``decode_fn``, the cache trees, decode continuing prefill, the rolling
window cache, the sinusoidal tables, the workloads' batches and the
serving loop.

Everything here is float32. Tolerances: the loss, gradients, logits and
caches against the reference at rtol = atol = 1e-5 (two frameworks'
einsums summed in different orders; the JAX flash path runs Pallas in
interpret mode); decode continuing prefill at CONTINUE_TOL (1e-4, the
bound of ``tests/test_ssd.py::test_prefill_state_continues_decode``:
attention over a cache against the masked full-sequence path); the
sinusoidal table at n * 2**-23 absolute (an angle of position n carries
about n ulps of 2**-23 rad, so a ``pow`` or a division that rounds
differently from XLA's moves a value by that much)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models import params as jax_params_lib
from repro.models import workloads as jax_workloads
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
from repro_torch.models.workloads import build_workload, train_step

from test_torch_models import _flatten
from test_torch_serving import _flatten_shapes, _jax_tree
from test_torch_ssm import _close_trees, _jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
CONTINUE_TOL = dict(rtol=1e-4, atol=1e-4)        # tests/test_ssd.py
ARCHS = ["granite_moe_1b_a400m", "mixtral_8x22b", "llama_3_2_vision_11b",
         "whisper_base"]
STEP = dict(remat=False)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


def _inputs(cfg, b: int, s: int, seed: int) -> dict:
    """Tokens (B, S) and the family's other inputs, from one numpy seed:
    standard normal ``frames`` (enc-dec) or ``image_embeds`` (VLM)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_enc)).astype(np.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _with_tokens(batch: dict, tokens) -> dict:
    return {**batch, "tokens": tokens}


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


def _defs(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _defs(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_match_the_reference(arch):
    """Every leaf of the full and the SMOKE config's tree: path, shape,
    logical axes, initializer and scale."""
    for cfg, ref_cfg in ((configs.get(arch), jax_configs.get(arch)),
                         (configs.get_smoke(arch),
                          jax_configs.get_smoke(arch))):
        ours = dict(_defs(api.param_defs(cfg)))
        theirs = dict(_defs(jax_api.param_defs(ref_cfg)))
        assert sorted(ours) == sorted(theirs)
        for path, d in ours.items():
            r = theirs[path]
            assert (d.shape, d.logical, d.init, d.scale) == \
                (r.shape, r.logical, r.init, r.scale), path
            assert d.dtype == cfg.tdtype


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(arch: str, use_flash: bool):
    """The SMOKE config's weights, inputs, and JAX ``value_and_grad`` of
    its loss with remat off (one compile serves both remat cases)."""
    ref_cfg = jax_configs.get_smoke(arch)
    params = _jax_params(ref_cfg)
    batch = _inputs(ref_cfg, 2, 32, 11)
    knobs = JaxStepConfig(use_flash=use_flash, flash_block_q=64,
                          flash_block_k=64, remat=False)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_api.loss_fn(
        p, _jax_tree(batch), ref_cfg, knobs)))(_jax_tree(params))
    return params, batch, float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_flash", [0, 1])
@pytest.mark.parametrize("remat", [0, 1])
def test_loss_and_gradients_match_the_reference(arch, use_flash, remat):
    params, batch, ref_loss, ref_grads = _reference_loss_and_grads(
        arch, bool(use_flash))
    loss, grads = train_step(from_numpy(params, device="cpu"),
                             _torch_batch(batch),
                             cfg=configs.get_smoke(arch),
                             step=StepConfig(use_flash=bool(use_flash),
                                             flash_block_q=64,
                                             flash_block_k=64,
                                             remat=bool(remat)))
    assert abs(float(loss) / ref_loss - 1.0) < TOL["rtol"]
    want = dict(_flatten(ref_grads))
    got = dict(_flatten(grads))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[path], err_msg=path,
                                   **TOL)


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


def _jax_prefill(ref_cfg, params, batch):
    return jax.jit(lambda p, b: jax_api.prefill_fn(
        p, b, ref_cfg, JaxStepConfig(**STEP)))(_jax_tree(params),
                                               _jax_tree(batch))


def _jax_decoder(ref_cfg):
    return jax.jit(lambda p, b, c, pos: jax_api.decode_fn(
        p, b, c, pos, ref_cfg, JaxStepConfig(**STEP)))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_a_decode_step_match_the_reference(arch):
    ref_cfg, cfg = jax_configs.get_smoke(arch), configs.get_smoke(arch)
    params = _jax_params(ref_cfg)
    batch = _inputs(ref_cfg, 2, 12, 21)
    nxt = _inputs(ref_cfg, 2, 1, 22)["tokens"]
    want_logits, want_cache = _jax_prefill(ref_cfg, params, batch)
    ours = from_numpy(params, device="cpu")
    logits, cache = api.prefill_fn(ours, _torch_batch(batch), cfg,
                                   StepConfig(**STEP))
    assert set(cache) == set(want_cache)
    _close_trees({"logits": logits, **cache},
                 {"logits": want_logits, **want_cache}, TOL)
    want = _jax_decoder(ref_cfg)(
        _jax_tree(params), _jax_tree(_with_tokens(batch, nxt)),
        jax_api.extend_cache(want_cache, 3), jnp.int32(12))
    got = api.decode_fn(ours, _torch_batch(_with_tokens(batch, nxt)),
                        api.extend_cache(cache, 3), 12, cfg,
                        StepConfig(**STEP))
    _close_trees({"logits": got[0], **got[1]},
                 {"logits": want[0], **want[1]}, TOL)
    assert (got[1]["attn"]["pos"][..., 12] == 12).all()
    assert (got[1]["attn"]["pos"][..., 13:] == -1).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_continues_prefill(arch):
    """A prefill of 8 tokens, grown by 4 slots, then 4 teacher-forced
    decode steps give the last logits and every cache leaf of one
    prefill of the 12 tokens (MoE: drop-free routing in both)."""
    cfg = configs.get_smoke(arch)
    params = from_numpy(_jax_params(jax_configs.get_smoke(arch)),
                        device="cpu")
    batch = _torch_batch(_inputs(cfg, 2, 12, 31))
    tokens = batch["tokens"]
    step = StepConfig(**STEP)
    logits, cache = api.prefill_fn(
        params, _with_tokens(batch, tokens[:, :8]), cfg, step)
    cache = api.extend_cache(cache, 4)
    for t in range(8, 12):
        logits, cache = api.decode_fn(
            params, _with_tokens(batch, tokens[:, t:t + 1]), cache, t, cfg,
            step)
    want_logits, want = api.prefill_fn(params, batch, cfg, step)
    _close_trees({"logits": logits, **cache},
                 {"logits": want_logits, **want}, CONTINUE_TOL)


def test_mixtral_decodes_past_its_window_from_an_empty_cache():
    """mixtral (window 16) decodes 40 tokens from ``cache_init``: its
    16-slot rolling cache wraps twice. Every step's logits and the final
    cache must be the JAX package's decode, the last logits the port's
    prefill of the 40 tokens."""
    ref_cfg = jax_configs.get_smoke("mixtral_8x22b")
    cfg = configs.get_smoke("mixtral_8x22b")
    assert cfg.window == 16
    params = _jax_params(ref_cfg)
    ours = from_numpy(params, device="cpu")
    tokens = _inputs(cfg, 2, 40, 41)["tokens"]
    cache = api.cache_init(cfg, WorkloadShape("decode_40", 40, 2, "decode"),
                           device="cpu")
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
        want_logits, want_cache = decode(
            jp, {"tokens": jnp.asarray(tokens[:, t:t + 1])}, want_cache,
            jnp.int32(t))
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                                   err_msg=f"step {t}", **TOL)
    _close_trees(cache, want_cache, TOL)
    assert sorted(cache["attn"]["pos"][0, 0].tolist()) == list(range(24, 40))
    full_logits, _ = api.prefill_fn(ours, {"tokens": torch.from_numpy(tokens)},
                                    cfg, step)
    np.testing.assert_allclose(logits.numpy(), full_logits.numpy(),
                               **CONTINUE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cell", ["decode_32k", "prefill_32k"])
def test_cache_trees_match_the_reference(arch, cell):
    """The full config's decode cache: the VLM's holds only its 32 self
    layers, whisper's adds the cross K/V over its 1500 frames, and
    mixtral's window caps its length."""
    shape, ref_shape = {"decode_32k": (DECODE_32K, JAX_DECODE_32K),
                        "prefill_32k": (PREFILL_32K, JAX_PREFILL_32K)}[cell]
    cfg, ref_cfg = configs.get(arch), jax_configs.get(arch)
    want = dict(_flatten_shapes(jax_api.cache_shapes(ref_cfg, ref_shape)))
    got = dict(_flatten_shapes(api.cache_shapes(cfg, shape)))
    assert got == {k: (tuple(s), _DTYPES[str(d)]) for k, (s, d) in
                   want.items()}
    assert dict(_flatten_shapes(api.cache_init(cfg, shape,
                                               device="meta"))) == got
    layers_ = {"llama_3_2_vision_11b": 32}.get(arch, cfg.n_layers)
    assert got["/attn/k"][0][0] == layers_
    if arch == "whisper_base":
        assert got["/cross_k"][0] == (6, shape.global_batch, 8, 1500, 64)


def test_whisper_cache_init_equals_the_reference():
    shape = WorkloadShape("decode_24", 24, 2, "decode")
    got = api.cache_init(configs.get_smoke("whisper_base"), shape,
                         device="cpu")
    want = jax_api.cache_init(jax_configs.get_smoke("whisper_base"),
                              JaxWorkloadShape("decode_24", 24, 2, "decode"))
    _close_trees(got, want, dict(rtol=0, atol=0))
    assert (got["attn"]["pos"] == -1).all()
    assert got["cross_k"].shape == (2, 2, 4, 24, 16)


# ---------------------------------------------------------------------------
# Sinusoidal positions
# ---------------------------------------------------------------------------


def test_sinusoidal_positions_match_the_reference():
    n, d = 1500, 512
    got = layers.sinusoidal_positions(n, d).numpy()
    want = np.asarray(jax_layers.sinusoidal_positions(n, d))
    assert got.shape == want.shape == (n, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=n * 2.0 ** -23)
    smoke = configs.get_smoke("whisper_base")
    np.testing.assert_allclose(
        layers.sinusoidal_positions(smoke.n_frames, smoke.d_enc).numpy(),
        np.asarray(jax_layers.sinusoidal_positions(smoke.n_frames,
                                                   smoke.d_enc)), **TOL)
    pos = torch.tensor(1499)                       # decode's 0-d position
    row = layers.sinusoidal_at(pos, d)
    assert row.shape == (d,) and row.device == pos.device
    np.testing.assert_allclose(row.numpy(), want[1499], rtol=0,
                               atol=n * 2.0 ** -23)


# ---------------------------------------------------------------------------
# Workloads and serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_workloads_build_the_reference_batch(arch, kind):
    """Each step workload's batch has the reference's ``_model_batch``
    keys, shapes and dtypes (zero frames, normal image embeddings), and
    its step runs."""
    cfg, ref_cfg = configs.get_smoke(arch), jax_configs.get_smoke(arch)
    w = build_workload(f"{kind}_step", arch, device="cpu", seq_len=16)
    want = jax_workloads._model_batch(
        ref_cfg, JaxWorkloadShape("t", 16, 2, kind))
    batch = w.args[1]
    assert sorted(batch) == sorted(want)
    for key, x in batch.items():
        assert tuple(x.shape) == want[key].shape, key
    if "frames" in batch:
        assert torch.equal(batch["frames"], torch.zeros_like(
            batch["frames"]))
    if "image_embeds" in batch:
        e = batch["image_embeds"]
        assert e.dtype == cfg.tdtype and abs(float(e.std()) - 1.0) < 0.1
    out = w.fn(*w.args)
    assert bool(torch.isfinite(out[0]).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_generates(arch):
    r = serve(arch, batch=2, prompt_len=16, gen=4, device="cpu")
    assert r["tokens"].shape == (2, 4)
    vocab = configs.get_smoke(arch).vocab_size
    assert ((r["tokens"] >= 0) & (r["tokens"] < vocab)).all()
    assert r["prefill_s"] > 0 and r["decode_s_per_token"] > 0
    again = serve(arch, batch=2, prompt_len=16, gen=4, device="cpu")
    assert np.array_equal(r["tokens"], again["tokens"])   # seeded


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_loop_gives_the_reference_logits(arch):
    """The reference's greedy loop (its prefill and decode on the same
    weights, prompt and frames or image embeddings, which every decode
    step is also given) against the port's ``generate`` with the
    reference's tokens forced: the logits of every step."""
    ref_cfg, cfg = jax_configs.get_smoke(arch), configs.get_smoke(arch)
    batch_size, prompt_len, gen = 2, 16, 6
    params = _jax_params(ref_cfg)
    batch = _inputs(ref_cfg, batch_size, prompt_len, 51)
    logits, cache = _jax_prefill(ref_cfg, params, batch)
    cache = jax_api.extend_cache(cache, gen)
    decode = _jax_decoder(ref_cfg)
    jp, jb = _jax_tree(params), _jax_tree(batch)
    tokens = jnp.argmax(logits[:, -1:, :ref_cfg.vocab_size], axis=-1)
    want_tokens, want_logits = [tokens], [logits[:, -1:]]
    for t in range(gen - 1):
        logits, cache = decode(jp, _with_tokens(jb, tokens), cache,
                               jnp.int32(prompt_len + t))
        tokens = jnp.argmax(logits[:, :, :ref_cfg.vocab_size], axis=-1)
        want_tokens.append(tokens)
        want_logits.append(logits)
    want_tokens = np.array(jnp.concatenate(want_tokens, axis=1))
    want_logits = np.asarray(jnp.concatenate(want_logits, axis=1))
    inputs = {k: v for k, v in _torch_batch(batch).items() if k != "tokens"}
    out = generate(from_numpy(params, device="cpu"),
                   torch.from_numpy(batch["tokens"]), cfg, gen,
                   forced=torch.from_numpy(want_tokens), inputs=inputs)
    assert np.array_equal(out["tokens"].numpy(), want_tokens)
    np.testing.assert_allclose(out["logits"].numpy(), want_logits, **TOL)


def test_inference_routes_drop_free_and_training_with_drops(monkeypatch):
    """Prefill and decode route MoE tokens drop-free
    (``StepConfig.inference``, set by ``api``), the train step with
    drops, as the reference does."""
    from repro_torch.models import moe
    cfg = configs.get_smoke("granite_moe_1b_a400m")
    drops = []
    real = moe.apply_moe
    monkeypatch.setattr(moe, "apply_moe", lambda p, x, c, drop=True: (
        drops.append(drop), real(p, x, c, drop=drop))[1])
    step = dataclasses.replace(StepConfig(**STEP), use_flash=True)
    for name in ("prefill_step", "decode_step"):
        w = build_workload(name, cfg, step=step, device="cpu", seq_len=8)
        w.fn(*w.args)
    assert drops == [False] * (2 * cfg.n_layers)
    w = build_workload("train_step", cfg, step=step, device="cpu",
                       seq_len=8)
    w.fn(*w.args)
    assert drops[2 * cfg.n_layers:] == [True] * cfg.n_layers
