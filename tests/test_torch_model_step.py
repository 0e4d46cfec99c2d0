"""The port's whole-model benchmark against ``benchmarks/common.py``: the
same search space, one work term for every config (counted with
``FlopCounterMode`` on the ``meta`` device), and a tuning session of the
train step on the host that never launches the card's kernel."""

import dataclasses
import math

import pytest
import torch

import benchmarks.common as ref_common
from repro_torch.bench import common
from repro_torch.core import Direction, EvaluationSettings, Tuner
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models.workloads import (TINY_CONFIG, build_workload,
                                          workload_flops)

#: a short evaluation budget: the session's mechanics, not its numbers
SHORT = EvaluationSettings(max_invocations=2, max_iterations=5,
                           max_time_s=0.2, direction=Direction.MAXIMIZE)


@pytest.mark.parametrize("quick", [True, False])
def test_space_equals_the_reference(quick):
    ours = list(common.model_step_space(quick).configs())
    assert ours == list(ref_common.model_step_space(quick).configs())
    assert len(ours) == (8 if quick else 64)


def _forward_matmul_flops(cfg, b: int, s: int) -> float:
    """Matrix-product FLOPs of one forward pass on the plain path."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    tokens = b * s
    proj = 2 * tokens * d * (h + 2 * hkv) * dh + 2 * tokens * h * dh * d
    attn = 2 * 2 * b * h * s * s * dh          # dense scores and P @ V
    mlp = (3 if cfg.mlp_type == "glu" else 2) * 2 * tokens * d * cfg.d_ff
    logits = 2 * tokens * d * cfg.vocab_padded
    return cfg.n_layers * (proj + attn + mlp) + logits


def test_work_term_counts_the_plain_step():
    """Forward + backward is 3x the forward's products; the checkpointed
    loss chunks recompute the logits once more in the backward pass."""
    w = build_workload("train_step", device="cpu")
    b, s = w.args[1]["tokens"].shape
    fwd = _forward_matmul_flops(TINY_CONFIG, b, s)
    logits = 2 * b * s * TINY_CONFIG.d_model * TINY_CONFIG.vocab_padded
    assert workload_flops(w) == 3 * fwd + logits


def test_work_term_is_one_for_every_config():
    base = build_workload("train_step", device="cpu")
    terms = {workload_flops(common._model_step(base, cfg))
             for cfg in common.model_step_space(False).configs()}
    assert terms == {workload_flops(base)}
    flash = common._model_step(base, {"use_flash": 1, "flash_block_q": 256,
                                      "flash_block_k": 64, "remat": 1})
    assert (flash.step.use_flash, flash.step.flash_block_q,
            flash.step.flash_block_k, flash.step.remat) == (True, 256, 64,
                                                           True)
    assert flash.args is base.args                 # same weights and tokens


def test_work_term_of_a_full_width_config_needs_no_memory():
    """granite-3-2b at full width, depth cut to 2, S = 4096: counted on
    the meta device (the chunked attention path is taken at this S, and
    its checkpointed chunks recompute the scores in the backward pass)."""
    from repro_torch.configs import get
    from repro_torch.models.workloads import step_flops
    cfg = dataclasses.replace(get("granite_3_2b"), n_layers=2)
    fwd = _forward_matmul_flops(cfg, 1, 4096)
    assert 3 * fwd < step_flops(cfg, 1, 4096) < 5 * fwd


def test_host_session_tunes_every_config_without_the_kernel():
    reset_launch_counts()
    result = Tuner(common.model_step_space(True), SHORT).tune(
        common.model_step_family("train_step", device="cpu"))
    assert len(result.trials) == 8
    assert math.isfinite(result.best_score) and result.best_score > 0
    assert launch_counts()["flash_attention"] == 0


def test_precompile_builds_the_shared_workload_once(monkeypatch):
    from repro_torch.bench import common as module
    built = []
    real = module.build_workload

    def spy(*args, **kw):
        built.append(kw["seq_len"])
        return real(*args, **kw)

    monkeypatch.setattr(module, "build_workload", spy)
    bench = module.model_step_family("train_step", "granite-3-2b",
                                     batch_size=1, seq_len=16, device="cpu")
    assert bench.__name__ == "model_step_train_step"
    bench.precompile({"use_flash": 1, "flash_block_q": 64,
                      "flash_block_k": 64})
    sampler = bench({"use_flash": 0, "flash_block_q": 64,
                     "flash_block_k": 64})()
    assert sampler() > 0
    assert built == [16]


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        common.model_step_family("train_step")
    with pytest.raises(RuntimeError, match="is_available"):
        build_workload("train_step")
