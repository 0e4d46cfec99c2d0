"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the card, the flash kernel's gradients, and tuning sessions
through the kernels.

Marked ``gpu``; each skips from inside the ``card`` fixture when no card
is visible, so every worker collects the same tests. Run them on a
machine with an NVIDIA card (sm_90a, nvcc on PATH or /usr/local/cuda):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dtype, device):
    return torch.randn(*shape, generator=gen).to(device).to(dtype)


@pytest.mark.parametrize("m,n,k", [(300, 450, 200), (1024, 256, 128),
                                   (129, 65, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_matches_plain_on_card(card, m, n, k, dtype):
    from repro_torch.kernels.matmul import TILES, matmul, matmul_ref
    gen = torch.Generator().manual_seed(m + n + k)
    a = _randn(gen, m, k, dtype=dtype, device=card)
    b = _randn(gen, k, n, dtype=dtype, device=card)
    want = matmul_ref(a, b)
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-4)
    for bm, bn, bk in TILES:
        before = matmul.launches
        got = matmul(a, b, bm=bm, bn=bn, bk=bk)
        torch.cuda.synchronize()
        assert matmul.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), **tol)
        got.fill_(float("nan"))   # a stale buffer must not pass next time


@pytest.mark.parametrize("n", [1, 7, 1024, 1_048_576 + 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_triad_kernel_matches_plain_on_card(card, n, dtype, offset):
    from repro_torch.kernels.triad import triad, triad_ref
    gen = torch.Generator().manual_seed(n)
    a = _randn(gen, n + offset, dtype=dtype, device=card)[offset:]
    b = _randn(gen, n + offset, dtype=dtype, device=card)[offset:]
    before = triad.launches
    got = triad(a, b, gamma=3.0)
    torch.cuda.synchronize()
    assert triad.launches == before + 1
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16 else \
        dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got.float(), triad_ref(a, b, 3.0).float(),
                               **tol)


def test_triad_session_goes_through_the_kernel(card, tmp_path):
    from repro_torch.bench.common import paper_settings, triad_benchmark
    from repro_torch.core import Tuner, grid
    from repro_torch.kernels.triad import triad
    before = triad.launches
    result = Tuner(grid(n_bytes=(1 << 20, 1 << 24)),
                   paper_settings(True)).tune(triad_benchmark("cuda"))
    assert result.best_score > 0 and len(result.trials) == 2
    assert triad.launches > before


FLASH_CASES = [  # (b, hq, hkv, s, d, causal, window)
    (2, 8, 2, 256, 64, True, None),
    (2, 8, 1, 256, 64, False, None),
    (1, 4, 2, 256, 32, True, 96),
    (1, 4, 4, 200, 32, True, None),
    (1, 4, 2, 250, 32, False, None),
    (1, 4, 2, 100, 16, True, None),
    (1, 4, 2, 300, 128, True, None),
    (1, 2, 1, 300, 256, True, 64),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(card, case, dtype):
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    b, hq, hkv, s, d, causal, window = case
    gen = torch.Generator().manual_seed(s + d)
    q = _randn(gen, b, hq, s, d, dtype=dtype, device=card)
    k = _randn(gen, b, hkv, s, d, dtype=dtype, device=card)
    v = _randn(gen, b, hkv, s, d, dtype=dtype, device=card)
    want = attention_ref(q, k, v, causal=causal, window=window)
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16 else \
        dict(rtol=2e-5, atol=2e-5)
    for bq in (64, 128, 256, 512):
        for bk in (64, 128, 256, 512):
            before = flash_attention.launches
            got = flash_attention(q, k, v, causal=causal, window=window,
                                  bq=bq, bk=bk)
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 1
            torch.testing.assert_close(got.float(), want.float(), **tol)
            got.fill_(float("nan"))


def test_flash_gradients_equal_the_plain_version_on_card(card):
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    gen = torch.Generator().manual_seed(7)
    qkv = [_randn(gen, 1, 8, 300, 64, dtype=torch.bfloat16, device=card),
           _randn(gen, 1, 2, 300, 64, dtype=torch.bfloat16, device=card),
           _randn(gen, 1, 2, 300, 64, dtype=torch.bfloat16, device=card)]
    g = _randn(gen, 1, 8, 300, 64, dtype=torch.bfloat16, device=card)
    leaves = [t.clone().requires_grad_() for t in qkv]
    got = torch.autograd.grad(flash_attention(*leaves, bq=64, bk=64), leaves,
                              g)
    leaves = [t.clone().requires_grad_() for t in qkv]
    want = torch.autograd.grad(attention_ref(*leaves), leaves, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)      # the backward is the plain math


def test_model_step_session_goes_through_the_flash_kernel(card):
    from repro_torch.bench.common import model_step_family, model_step_space
    from repro_torch.core import Direction, EvaluationSettings, Tuner
    from repro_torch.kernels.flash_attention import flash_attention
    before = flash_attention.launches
    settings = EvaluationSettings(max_invocations=2, max_iterations=5,
                                  max_time_s=0.2,
                                  direction=Direction.MAXIMIZE)
    result = Tuner(model_step_space(True), settings).tune(
        model_step_family("train_step", "granite_3_2b", batch_size=2,
                          seq_len=256))
    assert len(result.trials) == 8 and result.best_score > 0
    assert flash_attention.launches > before
