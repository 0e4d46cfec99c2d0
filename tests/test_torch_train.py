"""The port's step builders and training launcher against the JAX
package's: ``build_train_step`` against the reference's jitted one on the
SMOKE config of every family (dense, moe, ssm, hybrid, vlm, encdec, and
minicpm for the WSD schedule), with micro-batches and bfloat16 gradients
among them; the prefill and decode bundles; the launcher resuming a
checkpoint the reference wrote; the loss falling over 40 steps (the
reference's ``tests/test_system.py::test_training_loss_decreases``).

Tolerances. The three steps start from the reference's weights
(``params.from_numpy``) on the same numpy batch, at steps 150-152 of a
160-step run (past the 100-step warmup, so the cosine and WSD schedules
differ): the loss, the global norm and the lr of each step to rtol 1e-5
(two frameworks' einsums and reductions summed in different orders). The
parameters after the three steps within 2·Σlr per element (plus 1e-5 of
the element): Adam normalizes each gradient, so an element whose
near-zero gradient takes another sign in the other framework moves by up
to 2·lr a step. The launcher resuming the reference's checkpoint: the
losses of steps 3-5 equal the reference's straight 6-step run to rtol
1e-4, the reference's own resume criterion."""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.launch.mesh import make_host_mesh
from repro.models import api as jax_api
from repro.models import params as jax_params_lib
from repro.models.config import WorkloadShape as JaxWorkloadShape
from repro.models.config import input_specs
from repro.models.transformer import StepConfig as JaxStepConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.train import steps as jax_steps
from repro_torch import configs
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import train
from repro_torch.models import api
from repro_torch.models.config import WorkloadShape
from repro_torch.models.params import from_numpy
from repro_torch.models.transformer import StepConfig
from repro_torch.optim import adamw_init
from repro_torch.train import steps

PEAK_LR, TOTAL, FIRST_STEP, N_STEPS = 3e-3, 160, 150, 3
B, S = 4, 16
#: (arch, execution knobs): one compile of the reference each
CASES = [("granite_3_2b", {}),
         ("granite_moe_1b_a400m", {"microbatches": 2}),
         ("mamba2_130m", {"grad_bf16": True}),
         ("zamba2_2_7b", {"microbatches": 2}),
         ("llama_3_2_vision_11b", {}),
         ("whisper_base", {"grad_bf16": True}),
         ("minicpm_2b", {"microbatches": 2, "grad_bf16": True})]


def _batch(cfg) -> dict:
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_enc)).astype(np.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


@functools.lru_cache(maxsize=None)
def _reference(arch: str, knobs: tuple):
    """The reference's weights, batch, and its jitted train step's
    metrics and parameters over N_STEPS steps."""
    cfg = jax_configs.get_smoke(arch)
    defs = jax_api.param_defs(cfg)
    init = jax.tree.map(np.asarray, jax_params_lib.materialize(
        jax.random.key(0), defs))
    batch = _batch(cfg)
    bundle = jax_steps.build_train_step(
        cfg, JaxWorkloadShape("t", S, B, "train"), make_host_mesh(), None,
        JaxStepConfig(**dict(knobs)), peak_lr=PEAK_LR, total_steps=TOTAL)
    fn = jax.jit(bundle.fn)
    params = jax.tree.map(jnp.asarray, init)
    opt = jax_adamw_init(defs)
    metrics = []
    for i in range(N_STEPS):
        params, opt, m = fn(params, opt, batch, np.int32(FIRST_STEP + i))
        metrics.append({k: float(v) for k, v in m.items()})
    return init, batch, metrics, dict(_flat(jax.tree.map(np.asarray, params)))


@pytest.mark.parametrize("arch,knobs", CASES,
                         ids=[f"{a}-{'-'.join(k) or 'plain'}"
                              for a, k in CASES])
def test_train_step_matches_the_reference(arch, knobs):
    init, batch, want, want_params = _reference(arch, tuple(knobs.items()))
    cfg = configs.get_smoke(arch)
    params = from_numpy(init, device="cpu")
    opt = adamw_init(api.param_defs(cfg), "cpu")
    bundle = steps.build_train_step(cfg, WorkloadShape("t", S, B, "train"),
                                    step_cfg=StepConfig(**knobs),
                                    peak_lr=PEAK_LR, total_steps=TOTAL)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    lrs = []
    for i in range(N_STEPS):
        params, opt, m = bundle.fn(params, opt, tbatch, FIRST_STEP + i)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), want[i][key],
                                       rtol=1e-5, err_msg=f"{key} step {i}")
        lrs.append(want[i]["lr"])
    assert float(opt["count"]) == N_STEPS
    bound = 2.0 * sum(lrs)
    got = dict(_flat(params))
    assert sorted(got) == sorted(want_params)
    for path, x in got.items():
        diff = np.abs(x.float().numpy() - want_params[path].astype(
            np.float32))
        limit = bound + 1e-5 * np.abs(want_params[path].astype(np.float32))
        assert (diff <= limit).all(), (path, float(diff.max()), bound)


def test_schedules_follow_the_config():
    """minicpm trains on WSD, the others on cosine: past the decay start
    the two differ, and each step's lr is the schedule's."""
    wsd = _reference("minicpm_2b", (("microbatches", 2),
                                    ("grad_bf16", True)))[2]
    cos = _reference("granite_3_2b", ())[2]
    assert configs.get_smoke("minicpm_2b").lr_schedule == "wsd"
    assert [m["lr"] for m in wsd] != [m["lr"] for m in cos]


def test_micro_batches_split_the_rows():
    x = torch.arange(12).reshape(4, 3)
    parts = steps._micro_batches({"tokens": x}, 2)
    assert torch.equal(parts[0]["tokens"], x[:2])
    assert torch.equal(parts[1]["tokens"], x[2:])
    with pytest.raises(ValueError, match="split"):
        steps._micro_batches({"tokens": x}, 3)


def _shapes(tree) -> dict:
    return {path: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for path, x in _flat(tree)}


@pytest.mark.parametrize("arch", ["granite_3_2b", "whisper_base",
                                  "llama_3_2_vision_11b", "zamba2_2_7b"])
def test_bundles_abstract_args_match_the_reference(arch):
    """Meta tensors of the reference's shapes and dtypes (tokens int64 in
    the port, int32 in the reference); nothing allocated."""
    cfg, ref_cfg = configs.get_smoke(arch), jax_configs.get_smoke(arch)
    for kind in ("train", "prefill", "decode"):
        shape = WorkloadShape(kind, 32, 2, kind)
        bundle = steps.build_step(cfg, shape)
        ref_shape = JaxWorkloadShape(kind, 32, 2, kind)
        leaves = [x for a in bundle.abstract_args if isinstance(a, dict)
                  for _, x in _flat(a)]
        assert all(x.device.type == "meta" for x in leaves)
        params = bundle.abstract_args[0]
        want = {p: (tuple(x.shape), str(x.dtype)) for p, x in _flat(
            jax_params_lib.shape_tree(jax_api.param_defs(ref_cfg)))}
        assert _shapes(params) == want
        batch = bundle.abstract_args[2 if kind == "train" else 1]
        want_batch = {f"/{k}": (tuple(v.shape), str(v.dtype)) for k, v in
                      input_specs(ref_cfg, ref_shape).items()}
        want_batch["/tokens"] = (want_batch["/tokens"][0], "int64")
        assert _shapes(batch) == want_batch
        if kind == "train":
            assert set(bundle.abstract_args[1]) == {"m", "v", "count"}
        if kind == "decode":
            want_cache = {p: tuple(x.shape) for p, x in _flat(
                jax_api.cache_shapes(ref_cfg, ref_shape))}
            assert {p: s for p, (s, _) in
                    _shapes(bundle.abstract_args[2]).items()} == want_cache


def test_prefill_and_decode_bundles_run_the_api():
    cfg = configs.get_smoke("granite_3_2b")
    params = from_numpy(jax.tree.map(np.asarray, jax_params_lib.materialize(
        jax.random.key(0), jax_api.param_defs(
            jax_configs.get_smoke("granite_3_2b")))), device="cpu")
    tokens = torch.from_numpy(_batch(cfg)["tokens"]).long()
    pre = steps.build_prefill_step(cfg, WorkloadShape("p", S, B, "prefill"))
    logits, cache = pre.fn(params, {"tokens": tokens})
    want, _ = api.prefill_fn(params, {"tokens": tokens}, cfg, StepConfig())
    assert torch.equal(logits, want) and not logits.requires_grad
    dec = steps.build_decode_step(cfg, WorkloadShape("d", S, B, "decode"))
    cache = api.extend_cache(cache, 1)
    nxt = logits[:, -1:, :cfg.vocab_size].argmax(-1)
    out, cache2 = dec.fn(params, {"tokens": nxt}, cache, S)
    assert out.shape == (B, 1, cfg.vocab_padded) and cache2 is not None
    assert torch.isfinite(out).all()


def test_default_step_cfg_accumulates_above_ten_billion():
    train_shape = WorkloadShape("t", 4096, 256, "train")
    big = configs.get("command_r_plus_104b")
    assert steps.default_step_cfg(big, train_shape).microbatches == 4
    assert steps.default_step_cfg(
        big, WorkloadShape("p", 4096, 1, "prefill")).microbatches == 1
    assert steps.default_step_cfg(configs.get("granite_3_2b"),
                                  train_shape).microbatches == 1
    ref = jax_steps.default_step_cfg(jax_configs.get("command_r_plus_104b"),
                                     JaxWorkloadShape("t", 4096, 256,
                                                      "train"))
    assert dataclasses.asdict(ref) == dataclasses.asdict(
        steps.default_step_cfg(big, train_shape))


def test_the_launcher_resumes_a_reference_checkpoint(tmp_path, monkeypatch):
    """The reference trains 3 steps and checkpoints; the port's launcher
    resumes from that checkpoint to step 6 on the reference's tokens."""
    from repro.launch.train import train as jax_train
    kw = dict(batch=2, seq=32, smoke=True, log_every=100)
    ck = str(tmp_path / "ck")
    jax_train("granite_3_2b", steps=3, ckpt_dir=ck, **kw)
    full = jax_train("granite_3_2b", steps=6, ckpt_dir=None, **kw)
    ref_pipe = JaxSyntheticLM(JaxDataConfig(vocab_size=512), 2, 32)

    def reference_batch(self, step):
        toks = np.asarray(ref_pipe.batch_at(step)["tokens"])
        return {"tokens": torch.from_numpy(toks.astype(np.int64))}

    monkeypatch.setattr(SyntheticLM, "batch_at", reference_batch)
    ours = train("granite_3_2b", steps=6, ckpt_dir=ck, device="cpu", **kw)
    assert len(ours["losses"]) == 3
    np.testing.assert_allclose(ours["losses"], full["losses"][3:], rtol=1e-4)


def test_training_loss_decreases():
    r = train("mamba2_130m", steps=40, batch=4, seq=64, smoke=True,
              log_every=1000, device="cpu")
    assert r["losses"][-1] < r["losses"][0] - 0.05
    assert r["mean_step_s"] > 0 and len(r["losses"]) == 40


def test_the_110m_example_registers_the_reference_config(monkeypatch):
    from examples import train_100m as ref_example
    from repro_torch.examples import train_100m
    monkeypatch.setattr(configs, "ARCH_IDS", list(configs.ARCH_IDS))
    try:
        train_100m.register()
        assert configs.get("granite_110m") is train_100m.MODEL_100M
        assert configs.get_smoke("granite_110m") is train_100m.MODEL_100M
    finally:
        sys.modules.pop(f"{configs.__name__}.granite_110m", None)
    ours = dataclasses.asdict(train_100m.MODEL_100M)
    assert ours == dataclasses.asdict(ref_example.MODEL_100M)
    assert train_100m.MODEL_100M.n_params() == \
        ref_example.MODEL_100M.n_params()
