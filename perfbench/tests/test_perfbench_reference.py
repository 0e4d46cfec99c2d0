"""The plain references against the port at the SMOKE widths on the CPU
(float32 on both sides, so they agree to rounding), and the reference's
prefix path against its whole-sequence path. Then every cell end to end
at its test size, which the sound program passes."""

import dataclasses

import pytest
import torch

from perfbench.lib import weights
from perfbench.reference import dense, gemm


def _setup(arch):
    from repro_torch import configs
    from repro_torch.models import api
    cfg = configs.get_smoke(arch)
    pc = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    w = weights.make(api.param_defs(cfg), 7, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(3))
    return cfg, pc, w, tokens


@pytest.mark.parametrize("arch,ref", [("granite_3_2b", dense)])
def test_reference_matches_the_port(arch, ref):
    from repro_torch.models import api
    from repro_torch.models.transformer import StepConfig
    cfg, pc, w, tokens = _setup(arch)
    step = StepConfig(remat=False, loss_chunk=8)
    with torch.no_grad():
        port, _ = api.prefill_fn(w, {"tokens": tokens}, cfg, step)
    want = ref.forward(w, pc, tokens, logits_from=tokens.shape[1] - 1)
    torch.testing.assert_close(port[..., :cfg.vocab_size].float(),
                               want["logits"], rtol=1e-4, atol=1e-4)


def test_dense_prefix_path_matches_the_whole_sequence():
    _, pc, w, tokens = _setup("granite_3_2b")
    whole = dense.forward(w, pc, tokens)
    head = dense.forward(w, pc, tokens[:, :20])
    tail = dense.forward(w, pc, tokens[:, 20:], start=20,
                         prefix=lambda i: head["kv"][i])
    torch.testing.assert_close(tail["logits"], whole["logits"][:, 20:],
                               rtol=1e-5, atol=1e-5)


def test_gemm_reference_and_control():
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(64, 48, generator=g), torch.randn(48, 32, generator=g)
    c64 = gemm.product(a, b)
    assert c64.dtype == torch.float64
    err = (gemm.product(a, b, "tf32").double() - c64).abs().max() / \
        c64.abs().max()
    assert 1e-5 < float(err) < 1e-2        # TF32's 10-bit mantissa shows


@pytest.mark.parametrize("workload", ["granite-3-2b.tune_gemm_f32",
                                      "granite-3-2b.serve_decode_32k",
                                      "granite-3-2b.serve_prefill_4k"])
def test_sound_program_is_correct(workload, run_small):
    out = run_small(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
