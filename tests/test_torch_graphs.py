"""The port's captured steps (``repro_torch.graphs``, the counterpart of
``jax.jit``) through the helper's staging on the host: the same static
buffers, device scalars, donated write-backs and output buffers as a
CUDA graph, with the recorded step called directly in place of a
replay. Card capture itself is in ``tests/test_torch_gpu.py``.

Through the staging: the helper's rules (signature, warm-up, device
scalars, donation, held and copied inputs, output buffers, release, the
host-sync guard, launch counts under replay); ``generate``'s greedy
tokens for the granite, zamba2, mamba2, whisper and llama-vision SMOKE
configs against the eager loop's (equal) and, with the reference's
tokens forced, its logits against the JAX package's loop at rtol = atol
= 1e-5 (``tests/test_torch_serving.py``'s tolerance: two frameworks'
einsums summed in different orders); three train steps of the granite
and mamba2 SMOKE configs through ``StepBundle.jitted()`` against the
eager steps (bitwise: the same ops on the same host); the decode
bundle; and the model-step family's captured samples.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.models import api as jax_api
from repro_torch import configs, graphs
from repro_torch.bench.common import model_step_family
from repro_torch.kernels import counting, launch_counts, reset_launch_counts
from repro_torch.kernels.ssd import ssd_chunk_scan
from repro_torch.launch.serve import generate
from repro_torch.models import api
from repro_torch.models.config import WorkloadShape
from repro_torch.models.params import flatten, from_numpy, materialize
from repro_torch.models.transformer import StepConfig
from repro_torch.optim import adamw_init
from repro_torch.train import steps

from test_torch_model_stack import (_inputs, _jax_decoder, _jax_prefill,
                                    _torch_batch, _with_tokens)
from test_torch_serving import _jax_tree
from test_torch_ssm import _jax_params

TOL = dict(rtol=1e-5, atol=1e-5)                 # tests/test_torch_serving.py
SERVED = ["granite_3_2b", "zamba2_2_7b", "mamba2_130m", "whisper_base",
          "llama_3_2_vision_11b"]


@pytest.fixture
def staged(monkeypatch):
    """Every caller takes the captured path on the host too."""
    monkeypatch.setattr(graphs, "enabled", lambda device: True)


# ---------------------------------------------------------------------------
# The helper's rules
# ---------------------------------------------------------------------------


def test_first_call_warms_up_the_second_captures_then_replays():
    calls = []

    def fn(x):
        calls.append(x)
        return x * 2

    step = graphs.captured(fn)
    x = torch.arange(4.0)
    assert torch.equal(step(x), x * 2)
    (entry,) = step._entries.values()
    assert entry.replay is None and calls[0] is x      # eager warm-up
    y = step(x)
    assert entry.replay is not None and torch.equal(y, x * 2)
    assert calls[1] is x                       # held: the same tensor
    assert step(x) is y                        # replays into its buffers
    assert len(step._entries) == 1 and len(calls) == 3


def test_signature_holds_shapes_dtypes_and_static_arguments():
    step = graphs.captured(lambda x, k: x * k)
    x = torch.ones(3)
    for args in ((x, 2), (x, 2), (torch.ones(4), 2), (x, 3),
                 (x.double(), 2)):
        step(*args)
    assert len(step._entries) == 4
    assert torch.equal(step(x, 3), x * 3) and torch.equal(step(x, 2), x * 2)


def test_device_scalar_is_read_from_a_static_tensor():
    seen = []

    def fn(x, pos):
        seen.append(pos)
        return x + pos

    step = graphs.captured(fn, device_scalars=(1,))
    x = torch.zeros(2)
    outs = [step(x, p).clone() for p in (3, 5, 7, 11)]
    assert [float(o[0]) for o in outs] == [3, 5, 7, 11]
    assert len(step._entries) == 1             # one signature for every pos
    assert all(isinstance(p, torch.Tensor) and p.ndim == 0 and
               p.dtype == torch.int64 for p in seen)
    assert seen[0] is seen[-1]                 # the same static tensor


def test_donated_leaf_returned_new_is_copied_back():
    def fn(state, x):
        state["kv"].add_(x)                        # written in place
        return x.sum(), {"kv": state["kv"], "ssm": state["ssm"] * 2 + x}

    state = {"kv": torch.zeros(3), "ssm": torch.ones(3)}
    ssm, kv = state["ssm"], state["kv"]
    step = graphs.captured(fn, donate_argnums=(0,))
    for i in range(4):
        total, state = step(state, torch.full((3,), float(i)))
        assert state["ssm"] is ssm and state["kv"] is kv
        assert float(total) == 3 * i
    # 1 -> 2 -> 5 -> 12 -> 27; 0 + 1 + 2 + 3
    assert torch.equal(ssm, torch.full((3,), 27.0))
    assert torch.equal(kv, torch.full((3,), 6.0))
    assert len(step._entries) == 1


def test_outputs_are_buffers_and_inputs_are_copied_in():
    step = graphs.captured(lambda x: x + 1)
    a, b, c = torch.zeros(2), torch.ones(2), torch.full((2,), 5.0)
    step(a)
    out_b = step(b)                    # capture: b differs from a, copied
    assert torch.equal(out_b, b + 1)
    out_c = step(c)
    assert out_c is out_b and torch.equal(out_b, c + 1)  # overwritten
    assert torch.equal(b, torch.ones(2))       # the caller's b untouched


def test_swapping_a_held_input_starts_the_signature_again():
    calls = []
    step = graphs.captured(lambda w, x: calls.append(1) or w * x)
    w, x = torch.full((2,), 2.0), torch.ones(2)
    step(w, x)
    step(w, x)                                 # w, x held in place
    w2 = torch.full((2,), 3.0)
    assert torch.equal(step(w2, x), w2 * x)    # a warm-up again, eager
    (entry,) = step._entries.values()
    assert entry.replay is None
    step(w2, torch.full((2,), 4.0))            # capture: x now copied
    assert torch.equal(step(w2, torch.full((2,), 5.0)), w2 * 5)


@pytest.mark.parametrize("sync", ["item", "float", "nonzero"])
def test_a_step_that_reads_the_device_on_the_host_is_refused(sync):
    def fn(x):
        if sync == "item":
            return x * x.sum().item()
        if sync == "float":
            return x * float(x.max())
        return x[torch.nonzero(x > 0).squeeze(-1)]

    step = graphs.captured(fn)
    x = torch.arange(3.0)
    step(x)                                    # the eager warm-up runs
    with pytest.raises(graphs.HostSyncError):
        step(x)
    assert step._entries == {}                 # nothing kept


def test_release_frees_the_graphs_and_warms_up_again():
    step = graphs.captured(lambda x: x * 3)
    x = torch.ones(2)
    step(x)
    step(x)
    step.release()
    assert step._entries == {}
    assert torch.equal(step(x), x * 3)
    (entry,) = step._entries.values()
    assert entry.replay is None


def test_disabled_runs_every_step_eagerly():
    assert not graphs.enabled("cpu")
    assert not graphs.enabled(torch.device("meta"))
    with graphs.disabled():
        assert not graphs.enabled("cuda")
        with graphs.disabled():
            assert not graphs.enabled("cuda")
        assert not graphs.enabled("cuda")


def test_captured_launches_are_recorded_and_counted_at_each_replay(
        monkeypatch):
    """A launch into a capturing stream runs nothing: it goes into the
    open capture's record, and the record counts at every replay."""
    reset_launch_counts()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with counting.recording() as seen:
        counting.count_launch(ssd_chunk_scan)
    assert seen == [(ssd_chunk_scan, None)]
    assert launch_counts()["ssd_chunk_scan"] == 0
    for _ in range(3):
        counting.add(seen)
    assert launch_counts()["ssd_chunk_scan"] == 3
    counting.count_launch(ssd_chunk_scan)      # no capture open: counted
    assert launch_counts()["ssd_chunk_scan"] == 4
    reset_launch_counts()


# ---------------------------------------------------------------------------
# Serving: generate's decode
# ---------------------------------------------------------------------------


def _served(arch, seed):
    cfg = configs.get_smoke(arch)
    params = materialize(torch.Generator().manual_seed(seed),
                         api.param_defs(cfg))
    batch = _torch_batch(_inputs(cfg, 2, 12, seed))
    inputs = {k: v for k, v in batch.items() if k != "tokens"}
    return cfg, params, batch["tokens"], inputs


@pytest.mark.parametrize("arch", SERVED)
def test_staged_decode_gives_the_eager_tokens(arch, monkeypatch):
    cfg, params, prompt, inputs = _served(arch, 7)
    eager = generate(params, prompt, cfg, 8, inputs=inputs)
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
    replays = []
    replay = graphs.Captured.__call__

    def counted(self, *args):
        replays.append(any(e.replay is not None
                           for e in self._entries.values()))
        return replay(self, *args)

    monkeypatch.setattr(graphs.Captured, "__call__", counted)
    staged = generate(params, prompt, cfg, 8, inputs=inputs)
    assert replays == [False, False] + [True] * 5   # warm-up, capture, 5
    assert torch.equal(staged["tokens"], eager["tokens"])
    assert torch.equal(staged["logits"], eager["logits"])


@pytest.mark.parametrize("arch", SERVED)
def test_staged_decode_gives_the_reference_logits(arch, staged):
    """The reference's greedy loop against ``generate`` on the staged
    path with the reference's tokens forced: the logits of every step."""
    ref_cfg, cfg = jax_configs.get_smoke(arch), configs.get_smoke(arch)
    batch_size, prompt_len, gen = 2, 16, 6
    params = _jax_params(ref_cfg)
    batch = _inputs(ref_cfg, batch_size, prompt_len, 53)
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


def test_the_decode_bundle_stages_as_the_eager_one(staged):
    cfg, params, prompt, _ = _served("zamba2_2_7b", 3)
    bundle = steps.build_decode_step(cfg, WorkloadShape("d", 20, 2,
                                                        "decode"))
    logits, cache = api.prefill_fn(params, {"tokens": prompt}, cfg,
                                   StepConfig(remat=False))
    first = logits[:, -1:, :cfg.vocab_size].argmax(-1)
    runs = {}
    for label, fn in (("eager", bundle.fn), ("staged", bundle.jitted())):
        c = api.extend_cache(cache, 6)
        tok, toks = first, []
        for t in range(6):
            lg, c = fn(params, {"tokens": tok}, c, 12 + t)
            tok = lg[:, :, :cfg.vocab_size].argmax(-1)
            toks.append(tok)
        runs[label] = (torch.cat(toks, 1), {k: v.clone() for k, v in
                                            flatten(c).items()})
    assert torch.equal(runs["eager"][0], runs["staged"][0])
    assert all(torch.equal(v, runs["staged"][1][k])
               for k, v in runs["eager"][1].items())


# ---------------------------------------------------------------------------
# Training: StepBundle.jitted()
# ---------------------------------------------------------------------------


def _three_steps(arch: str, captured: bool) -> tuple[list, dict]:
    cfg = configs.get_smoke(arch)
    defs = api.param_defs(cfg)
    params = materialize(torch.Generator().manual_seed(0), defs)
    opt = adamw_init(defs, "cpu")
    bundle = steps.build_train_step(cfg, WorkloadShape("t", 16, 2, "train"),
                                    step_cfg=StepConfig(loss_chunk=8))
    fn = bundle.jitted()
    rng = np.random.default_rng(9)
    metrics = []
    for i in range(3):
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (2, 16)))}
        if captured:
            params, opt, mt = fn(params, opt, batch, i)
        else:
            params, opt, mt = bundle.fn(params, opt, batch, i)
        metrics.append({k: v.clone() for k, v in mt.items()})
    state = {f"p/{k}": v for k, v in flatten(params).items()}
    state.update({f"o/{k}": v for k, v in flatten(opt).items()})
    return metrics, state


@pytest.mark.parametrize("arch", ["granite_3_2b", "mamba2_130m"])
def test_three_staged_train_steps_equal_the_eager_ones(arch, monkeypatch):
    want_metrics, want = _three_steps(arch, captured=False)
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
    got_metrics, got = _three_steps(arch, captured=True)
    for a, b in zip(want_metrics, got_metrics):
        assert all(torch.equal(a[k], b[k]) for k in a), (a, b)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_the_train_bundle_donates_its_state_and_reads_the_step_there():
    cfg = configs.get_smoke("granite_3_2b")
    shape = WorkloadShape("t", 16, 2, "train")
    bundle = steps.build_train_step(cfg, shape)
    assert bundle.donate_argnums == (0, 1) and bundle.device_scalars == (3,)
    dec = steps.build_decode_step(cfg, WorkloadShape("d", 16, 2, "decode"))
    assert dec.donate_argnums == (2,) and dec.device_scalars == (3,)
    assert steps.build_prefill_step(cfg, shape).donate_argnums == ()


# ---------------------------------------------------------------------------
# The tuner's model steps
# ---------------------------------------------------------------------------


def test_model_step_samples_replay_and_release_with_their_factory(staged):
    bench = model_step_family("decode_step", "zamba2_2_7b", batch_size=2,
                              seq_len=16, device="cpu")
    factory = bench({"use_flash": 0, "flash_block_q": 64,
                     "flash_block_k": 64})
    (step,) = [c.cell_contents for c in factory.__closure__
               if isinstance(c.cell_contents, graphs.Captured)]
    sample = factory()                           # pre-heat: warm-up, capture
    (entry,) = step._entries.values()
    assert entry.replay is not None
    assert all(sample() > 0 for _ in range(3))
    del factory, sample
    gc.collect()
    assert step._entries == {}                   # released with the factory
