"""The benchmark's work counts equal the port's own counts as they stand
today, at small shapes: the GEMM's FLOPs, and a prefill's and a decode
step's matrix-product FLOPs (the with ``FlopCounterMode`` on the ``meta`` device). The port's prefill computes every attention score of the S x S square and
its head over the padded vocabulary; the benchmark's model FLOPs count
the causal half over the vocabulary itself, so the comparison asks for
the port's convention."""

import dataclasses

import pytest

from perfbench.lib import counts


def _port_dict(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("m,n,k", [(64, 96, 32), (4096, 8192, 2048)])
def test_gemm_flops(m, n, k):
    from repro_torch.kernels.matmul import ops
    assert counts.gemm_flops(m, n, k) == ops.flops(m, n, k)


@pytest.mark.parametrize("arch", ["granite_3_2b"])
@pytest.mark.parametrize("batch,seq", [(1, 16), (2, 32)])
def test_prefill_flops_match_the_port(arch, batch, seq):
    from repro_torch import configs
    from repro_torch.models.workloads import step_flops
    cfg = configs.get_smoke(arch)
    port = step_flops(cfg, batch, seq, "prefill")
    mine = counts.prefill_flops(_port_dict(cfg), batch, seq, causal=False,
                                vocab=cfg.vocab_padded)
    assert mine == pytest.approx(port, rel=1e-12)


@pytest.mark.parametrize("batch,seq", [(1, 16), (3, 40)])
def test_decode_flops_match_the_port(batch, seq):
    from repro_torch import configs
    from repro_torch.models.workloads import step_flops
    cfg = configs.get_smoke("granite_3_2b")
    port = step_flops(cfg, batch, seq, "decode")
    mine = counts.decode_step_flops(_port_dict(cfg), batch, 0, cache=seq,
                                    vocab=cfg.vocab_padded)
    assert mine == pytest.approx(port, rel=1e-12)


def test_causal_attention_counts_half_the_square_and_the_window():
    cfg = {"n_heads": 2, "d_model": 16, "n_kv_heads": 1}
    per = 4.0 * 2 * 8
    assert counts.attention_flops(cfg, 0, 4) == per * (1 + 2 + 3 + 4)
    assert counts.attention_flops({**cfg, "window": 2}, 0, 4) == \
        per * (1 + 2 + 2 + 2)
    assert counts.attention_flops(cfg, 3, 2) == per * (4 + 5)
    # a decode step's causal keys are the prefill's last row, and on
    assert counts.attention_flops(cfg, 0, 10) == \
        counts.attention_flops(cfg, 0, 9) + counts.attention_flops(cfg, 9, 1)


def test_full_size_counts():
    """The numbers the issue reckons with: granite's MLP product 137.4
    GFLOP, its bound 0.83 ms at 165 TFLOP/s."""
    from perfbench.lib import peaks
    f = counts.gemm_flops(4096, 8192, 2048)
    assert f == pytest.approx(137.4e9, rel=1e-3)
    bound = peaks.bound_s(f, counts.gemm_bytes(4096, 8192, 2048),
                          peaks.F32_ACCURATE_FLOPS)
    assert bound == pytest.approx(0.8328e-3, rel=1e-3)
