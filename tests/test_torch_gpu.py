"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the card (the bf16 flash kernel at every compiled head dim and
physical tile, the GEMM at every tile), the flash and SSD kernels'
gradients, a mamba2 prefill through the SSD kernel, and tuning sessions
through the kernels (the GEMM tile search keeping all 12 tiles).

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
                                   (129, 65, 33), (257, 128, 66)])
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
    (1, 4, 4, 300, 80, True, 96),
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
    route = "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores"
    for bq in (64, 128, 256, 512):
        for bk in (64, 128, 256, 512):
            before = flash_attention.launches
            routed = flash_attention.route_launches[route]
            got = flash_attention(q, k, v, causal=causal, window=window,
                                  bq=bq, bk=bk)
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 1
            assert flash_attention.route_launches[route] == routed + 1
            torch.testing.assert_close(got.float(), want.float(), **tol)
            got.fill_(float("nan"))


@pytest.mark.parametrize("case", [(1, 4, 2, 300, True, 96),
                                  (2, 4, 1, 250, False, None),
                                  (1, 4, 2, 200, True, None)], ids=str)
def test_flash_tensor_core_kernel_every_tile_on_card(card, case):
    """The bf16 kernel at every compiled (head dim, physical tile), forced
    by (bq, bk) = the tile, on padded, windowed and GQA cases."""
    from repro_torch.kernels.flash_attention import (SM90_TILES,
                                                     attention_ref,
                                                     flash_attention,
                                                     physical_tile)
    b, hq, hkv, s, causal, window = case
    gen = torch.Generator().manual_seed(s)
    for d, tiles in SM90_TILES.items():
        q = _randn(gen, b, hq, s, d, dtype=torch.bfloat16, device=card)
        k = _randn(gen, b, hkv, s, d, dtype=torch.bfloat16, device=card)
        v = _randn(gen, b, hkv, s, d, dtype=torch.bfloat16, device=card)
        want = attention_ref(q, k, v, causal=causal, window=window)
        for qt, kt in tiles:
            assert physical_tile(qt, kt, tiles) == (qt, kt)
            before = flash_attention.launches
            routed = flash_attention.route_launches["tensor_cores"]
            got = flash_attention(q, k, v, causal=causal, window=window,
                                  bq=qt, bk=kt)
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 1
            assert flash_attention.route_launches["tensor_cores"] == \
                routed + 1
            torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                                       atol=3e-2)
            got.fill_(float("nan"))


def test_flash_raises_for_an_uncompiled_head_dim_on_card(card):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.zeros(1, 2, 128, 48, dtype=torch.bfloat16, device=card)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="no bf16 flash kernel"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    assert flash_attention.launches == before


def test_gemm_tiled_session_tunes_all_twelve_tiles_on_card(card,
                                                           monkeypatch):
    """The card's opt-in shared-memory limit keeps every tile of the table
    in the space (the static 48 KiB would drop the 128 x 128 x 32 tile)."""
    from repro_torch.bench import common
    from repro_torch.core import Tuner
    from repro_torch.kernels.matmul import matmul
    limit = common.block_smem_limit(card)
    assert limit >= 227 * 1024
    space = common.gemm_tiled_space(smem_limit=limit)
    assert space.cardinality == 12
    monkeypatch.setattr(common, "GEMM_TILED_SHAPE",
                        {"m": 512, "n": 256, "k": 128})
    before = matmul.launches
    result = Tuner(space, common.paper_settings(True)).tune(
        common.gemm_tiled_benchmark("cuda"))
    assert len(result.trials) == 12 and result.best_score > 0
    assert matmul.launches > before


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


@pytest.mark.parametrize("dtype,route", [("float32", "cuda_cores"),
                                         ("bfloat16", "tensor_cores")])
def test_model_step_session_goes_through_the_flash_kernel(card, dtype,
                                                          route):
    """The SMOKE granite (float32, head dim 16) and its bf16 copy: each
    session's flash launches all take the kernel of its dtype."""
    import dataclasses

    from repro_torch.bench.common import model_step_family, model_step_space
    from repro_torch.configs import get_smoke
    from repro_torch.core import Direction, EvaluationSettings, Tuner
    from repro_torch.kernels.flash_attention import flash_attention
    cfg = dataclasses.replace(get_smoke("granite_3_2b"), dtype=dtype)
    before = flash_attention.launches
    routes = dict(flash_attention.route_launches)
    settings = EvaluationSettings(max_invocations=2, max_iterations=5,
                                  max_time_s=0.2,
                                  direction=Direction.MAXIMIZE)
    result = Tuner(model_step_space(True), settings).tune(
        model_step_family("train_step", cfg, batch_size=2, seq_len=256))
    assert len(result.trials) == 8 and result.best_score > 0
    launched = flash_attention.launches - before
    assert launched > 0
    assert flash_attention.route_launches[route] - routes[route] == launched


SSD_CASES = [  # (B, H, C, Q, P, N, with h0)
    (2, 3, 4, 16, 8, 16, False),
    (1, 1, 3, 8, 4, 4, True),
    (1, 4, 3, 100, 64, 128, True),
    (1, 2, 2, 70, 80, 256, False),
    (1, 3, 2, 130, 33, 5, True),
    (2, 4, 2, 256, 64, 128, False),
]


def _ssd_inputs(gen, b, h, c, q, p, n, with_h0, device):
    xdt = _randn(gen, b, h, c, q, p, dtype=torch.float32, device=device)
    bm = _randn(gen, b, c, q, n, dtype=torch.float32, device=device)
    cm = _randn(gen, b, c, q, n, dtype=torch.float32, device=device)
    step = 0.01 + 0.19 * torch.rand((b, h, c, q), generator=gen)
    cum = torch.cumsum(-step, dim=-1).to(device)
    h0 = _randn(gen, b, h, p, n, dtype=torch.float32, device=device) \
        if with_h0 else None
    return 0.5 * xdt, 0.5 * bm, 0.5 * cm, cum, h0


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_kernel_matches_plain_on_card(card, case):
    """y and the final state within the reference tests' 2e-5, scaled by
    the outputs' magnitude (f32 sums in another order)."""
    from repro_torch.kernels.ssd import (chunk_scan, ssd_chunk_scan,
                                         ssd_chunk_scan_ref)
    gen = torch.Generator().manual_seed(sum(case[:6]))
    xdt, bm, cm, cum, h0 = _ssd_inputs(gen, *case, device=card)
    want = ssd_chunk_scan_ref(xdt, bm, cm, cum, h0=h0, return_state=True)
    before = ssd_chunk_scan.launches
    got = chunk_scan(xdt, bm, cm, cum, h0=h0, return_state=True)
    torch.cuda.synchronize()
    assert ssd_chunk_scan.launches == before + 1
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5 * scale)


def test_ssd_gradients_equal_the_plain_version_on_card(card):
    from repro_torch.kernels.ssd import chunk_scan, ssd_chunk_scan_ref
    gen = torch.Generator().manual_seed(11)
    ops = _ssd_inputs(gen, 1, 4, 3, 64, 32, 16, False, card)[:4]
    g = _randn(gen, 1, 4, 3, 64, 32, dtype=torch.float32, device=card)
    leaves = [t.clone().requires_grad_() for t in ops]
    got = torch.autograd.grad(chunk_scan(*leaves), leaves, g)
    leaves = [t.clone().requires_grad_() for t in ops]
    want = torch.autograd.grad(ssd_chunk_scan_ref(*leaves), leaves, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)      # the backward is the plain math


def test_mamba2_prefill_goes_through_the_ssd_kernel(card):
    """The SMOKE mamba2's prefill on the card launches the kernel once per
    layer and matches the same prefill on the host (plain version)."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.ssd import ssd_chunk_scan
    from repro_torch.models import api
    from repro_torch.models.params import map_tree, materialize
    from repro_torch.models.transformer import StepConfig
    cfg = get_smoke("mamba2_130m")
    params = materialize(torch.Generator().manual_seed(0),
                         api.param_defs(cfg))
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    step = StepConfig(remat=False)
    want_logits, want = api.prefill_fn(params, {"tokens": tokens}, cfg, step)
    on_card = map_tree(lambda _, t: t.to(card), params)
    before = ssd_chunk_scan.launches
    logits, cache = api.prefill_fn(on_card, {"tokens": tokens.to(card)}, cfg,
                                   step)
    torch.cuda.synchronize()
    assert ssd_chunk_scan.launches == before + cfg.n_layers
    torch.testing.assert_close(logits.cpu(), want_logits, rtol=1e-4,
                               atol=1e-4)
    for key in ("ssm", "conv"):
        torch.testing.assert_close(cache[key].cpu(), want[key], rtol=1e-4,
                                   atol=1e-4)
