"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the card (the bf16 and the f32 3xTF32 flash kernels at every
compiled head dim and physical tile, the GEMM at every tile of each
dtype's kernel: f32 on the CUDA cores, bf16 on the tensor cores), the flash
and SSD kernels' gradients, a mamba2 prefill through the SSD kernel,
tuning sessions through the kernels (the GEMM tile search keeping all 12
tiles, and a surrogate search over them recording its run in the
ledger), on-device timing of incumbent trials through torch.profiler,
the SMOKE granite and zamba2 decode on the card against the host,
three AdamW steps on the card against the same steps on the host, and
captured steps (``repro_torch.graphs``): every kernel route replayed
from a CUDA graph, ``generate``'s captured decode for each family's
SMOKE config, and three captured train steps without a mesh and on the
one-rank host mesh, each against the eager runs.

Marked ``gpu``; each skips from inside the ``card`` fixture when no card
is visible, so every worker collects the same tests (on the CPU they are
collected with the rest of the suite and skip). Run them on a machine
with an NVIDIA card (sm_90a, nvcc on PATH or /usr/local/cuda), without
the shared conftest, which imports jax:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import contextlib

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
    from repro_torch.kernels.matmul import matmul, matmul_ref, route, tiles
    gen = torch.Generator().manual_seed(m + n + k)
    a = _randn(gen, m, k, dtype=dtype, device=card)
    b = _randn(gen, k, n, dtype=dtype, device=card)
    want = matmul_ref(a, b)
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-4)
    path = route(dtype)   # bf16: the tensor cores, f32: the CUDA cores
    for bm, bn, bk in tiles(dtype):
        before = matmul.launches
        routes = dict(matmul.route_launches)
        got = matmul(a, b, bm=bm, bn=bn, bk=bk)
        torch.cuda.synchronize()
        assert matmul.launches == before + 1
        assert matmul.route_launches == {
            p: routes[p] + (p == path) for p in routes}
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
                                                     flash_attention, route)
    b, hq, hkv, s, d, causal, window = case
    gen = torch.Generator().manual_seed(s + d)
    q = _randn(gen, b, hq, s, d, dtype=dtype, device=card)
    k = _randn(gen, b, hkv, s, d, dtype=dtype, device=card)
    v = _randn(gen, b, hkv, s, d, dtype=dtype, device=card)
    want = attention_ref(q, k, v, causal=causal, window=window)
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16 else \
        dict(rtol=2e-5, atol=2e-5)
    # bf16 on the tensor cores; f32 on the 3xTF32 kernel up to D = 128
    # and on its D = 256 kernel (Q from registers) at 256 (every tile of
    # both is among these blocks)
    path = route(dtype, d)
    assert path == ("tensor_cores" if dtype == torch.bfloat16 else
                    "tf32x3_d256" if d == 256 else "tf32x3")
    for bq in (64, 128, 256, 512):
        for bk in (64, 128, 256, 512):
            before = flash_attention.launches
            routed = dict(flash_attention.route_launches)
            got = flash_attention(q, k, v, causal=causal, window=window,
                                  bq=bq, bk=bk)
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 1
            assert flash_attention.route_launches == {
                r: n + (r == path) for r, n in routed.items()}
            torch.testing.assert_close(got.float(), want.float(), **tol)
            got.fill_(float("nan"))


@pytest.mark.parametrize("case", [(1, 4, 2, 300, True, 96),
                                  (2, 4, 1, 250, False, None),
                                  (1, 4, 2, 200, True, None)], ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_tensor_core_kernel_every_tile_on_card(card, case, dtype):
    """The tensor-core kernels at every compiled (head dim, physical tile),
    forced by (bq, bk) = the tile, on padded, windowed and GQA cases: bf16
    (SM90_TILES) and f32 with 3xTF32 products (TF32X3_TILES, and
    TF32X3_D256_TILES on its own route)."""
    from repro_torch.kernels.flash_attention import (ROUTE_TILES,
                                                     attention_ref,
                                                     flash_attention,
                                                     physical_tile, route)
    b, hq, hkv, s, causal, window = case
    gen = torch.Generator().manual_seed(s)
    tol = (dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16 else
           dict(rtol=2e-5, atol=2e-5))
    routes = (("tensor_cores",) if dtype == torch.bfloat16 else
              ("tf32x3", "tf32x3_d256"))
    for d, tiles, path in [(d, tiles, r) for r in routes
                           for d, tiles in ROUTE_TILES[r].items()]:
        assert route(dtype, d) == path
        q = _randn(gen, b, hq, s, d, dtype=dtype, device=card)
        k = _randn(gen, b, hkv, s, d, dtype=dtype, device=card)
        v = _randn(gen, b, hkv, s, d, dtype=dtype, device=card)
        want = attention_ref(q, k, v, causal=causal, window=window)
        for qt, kt in tiles:
            assert physical_tile(qt, kt, tiles) == (qt, kt)
            before = flash_attention.launches
            routed = flash_attention.route_launches[path]
            got = flash_attention(q, k, v, causal=causal, window=window,
                                  bq=qt, bk=kt)
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 1
            assert flash_attention.route_launches[path] == routed + 1
            torch.testing.assert_close(got.float(), want.float(), **tol)
            got.fill_(float("nan"))


def test_flash_raises_for_an_uncompiled_head_dim_on_card(card):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.zeros(1, 2, 128, 48, dtype=torch.bfloat16, device=card)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="no bf16 flash kernel"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no f32 flash kernel"):
        flash_attention(q.float(), q.float(), q.float())   # no fallback
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


def test_gemm_tiled_surrogate_session_records_a_ledger_run_on_card(
        card, tmp_path, monkeypatch):
    """A surrogate session over the GEMM tiles launches the hand kernel
    and appends one run-ledger record under the card's fingerprint."""
    from repro_torch.bench import common
    from repro_torch.core import Tuner, TuningSession, hardware_fingerprint
    from repro_torch.history import RunLedger
    from repro_torch.kernels.matmul import matmul
    from repro_torch.surrogate import SurrogateStrategy
    monkeypatch.setattr(common, "GEMM_TILED_SHAPE",
                        {"m": 512, "n": 256, "k": 128})
    space = common.gemm_tiled_space(smem_limit=common.block_smem_limit(card))
    fingerprint = hardware_fingerprint("cuda")
    before = matmul.launches
    result = TuningSession(
        "surrogate", Tuner(space, common.paper_settings(True),
                           strategy=SurrogateStrategy(budget=6, seed=0)),
        common.gemm_tiled_benchmark("cuda"), cache_dir=tmp_path,
        fingerprint=fingerprint, benchmark_name="gemm_tiled").run(
        timestamp=1.0)
    assert len(result.trials) == 6 and result.best_score > 0
    assert matmul.launches > before
    runs = RunLedger(tmp_path / "history.jsonl").series("gemm_tiled",
                                                       fingerprint)
    assert len(runs) == 1 and fingerprint.startswith("cuda:")
    assert runs[0].strategy == "surrogate"
    assert runs[0].config == result.best_config


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


@pytest.mark.parametrize("dtype,route", [("float32", "tf32x3"),
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
    (1, 3, 4, 96, 64, 200, True),       # N = 200: a ragged last k slice
    (2, 2, 3, 128, 32, 256, False),     # N = 256, the widest state taken
    (1, 9, 8192, 8, 8, 16, False),      # B·H·C = 73,728 > 65,535 blocks
    (1, 3, 2, 50, 6, 10, True),         # rows of 24, 40, 200 bytes
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


@pytest.mark.parametrize("arch", ["granite_3_2b", "zamba2_2_7b"])
def test_serving_decode_on_card_matches_the_host(card, arch):
    """The SMOKE model's prefill (zamba2's through the SSD kernel) and 8
    decode steps on the card, the position a 0-d tensor there, match the
    same steps on the host (an int position), on the same weights."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import api
    from repro_torch.models.params import map_tree, materialize
    from repro_torch.models.transformer import StepConfig
    cfg = get_smoke(arch)
    params = materialize(torch.Generator().manual_seed(0),
                         api.param_defs(cfg))
    tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(1))
    step = StepConfig(remat=False)
    out = {}
    for dev, p in (("cpu", params),
                   ("cuda", map_tree(lambda _, t: t.to(card), params))):
        toks = tokens.to(dev)
        logits, cache = api.prefill_fn(p, {"tokens": toks[:, :16]}, cfg,
                                       step)
        cache = api.extend_cache(cache, 8)
        for t in range(16, 24):
            pos = t if dev == "cpu" else torch.tensor(t, device=card)
            logits, cache = api.decode_fn(p, {"tokens": toks[:, t:t + 1]},
                                          cache, pos, cfg, step)
        out[dev] = (logits, cache)
    torch.cuda.synchronize()
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0],
                               rtol=1e-4, atol=1e-4)
    want, got = out["cpu"][1], out["cuda"][1]
    for key in sorted(want):
        pairs = ([(want[key][k], got[key][k]) for k in ("k", "v", "pos")]
                 if key == "attn" else [(want[key], got[key])])
        for w, g in pairs:
            torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


def test_profile_sample_times_the_triad_kernel_on_card(card):
    from repro_torch.bench.common import triad_invocation_factory
    from repro_torch.obs import profile_ops, profile_sample
    sample = triad_invocation_factory(1 << 22, device=card)()
    timing = profile_sample(sample)
    assert timing.n_events == 1
    assert 0.0 < timing.device_time_s <= timing.host_time_s
    assert timing.skew_s == timing.host_time_s - timing.device_time_s
    ops = profile_ops(sample)
    assert list(ops.by_name) == ["triad_vec_kernel"]


def test_device_timing_instants_for_incumbent_trials_on_card(card):
    import dataclasses

    from repro_torch.bench.common import dgemm_benchmark, paper_settings
    from repro_torch.core import Tuner, grid
    from repro_torch.obs import TraceRecorder
    settings = dataclasses.replace(paper_settings(True),
                                   max_invocations=1, max_iterations=5,
                                   device_timing=True)
    with TraceRecorder() as rec:
        result = Tuner(grid(n=(512, 1024), m=(512,), k=(256,)),
                       settings).tune(dgemm_benchmark("cuda"))
    names = [e["name"] for e in rec.events() if e["type"] == "instant"]
    assert "device_timing_unavailable" not in names
    assert names.count("device_timing") == len(result.improvements) >= 1


def test_card_clock_times_the_product_kernel_on_card(card):
    """The DGEMM sampler's card clock reads the product kernel's own time
    (the profiler's kernel event), and its hold is no kernel of the
    profiled sample."""
    import statistics

    from repro_torch.bench.common import dgemm_flops, dgemm_invocation_factory
    from repro_torch.obs import profile_ops
    sample = dgemm_invocation_factory(2048, 2048, 2048, device=card)()
    ops = profile_ops(sample)
    assert ops.n_events == 1 and len(ops.by_name) == 1
    kernel_gflops = dgemm_flops(2048, 2048, 2048) / 1e9 / ops.total_s
    gflops = statistics.median(sample() for _ in range(9))
    assert gflops == pytest.approx(kernel_gflops, rel=0.04)


def _op_case(name, card):
    """A wrapper call, the same inputs through the op, and the formula."""
    import math

    from repro_torch.kernels import registry
    gen = torch.Generator().manual_seed(19)
    if name == "triad":
        from repro_torch.kernels.triad import flops, triad
        a, b = (_randn(gen, 4096, dtype=torch.float32, device=card)
                for _ in range(2))
        return (lambda: triad(a, b, gamma=3.0),
                lambda: registry.OPS[name](a, b, 3.0), flops(4096))
    if name == "matmul":
        from repro_torch.kernels.matmul import flops, matmul
        a = _randn(gen, 300, 200, dtype=torch.float32, device=card)
        b = _randn(gen, 200, 450, dtype=torch.float32, device=card)
        return (lambda: matmul(a, b, bm=64, bn=64, bk=8),
                lambda: registry.OPS[name](a, b, 64, 64, 8),
                flops(300, 450, 200))
    if name == "flash_attention_fwd":
        from repro_torch.kernels.flash_attention import flash_attention, flops
        q = _randn(gen, 1, 4, 300, 64, dtype=torch.bfloat16, device=card)
        k, v = (_randn(gen, 1, 2, 300, 64, dtype=torch.bfloat16,
                       device=card) for _ in range(2))
        return (lambda: flash_attention(q, k, v, bq=128, bk=128),
                lambda: registry.OPS[name](q, k, v, 1 / math.sqrt(64), True,
                                           None, 128, 128),
                flops(1, 4, 300, 64, True))
    from repro_torch.kernels.ssd import chunk_scan, needed_flops
    xdt = _randn(gen, 1, 3, 4, 32, 16, dtype=torch.float32, device=card)
    bm, cm = (_randn(gen, 1, 4, 32, 8, dtype=torch.float32, device=card)
              for _ in range(2))
    cum = -torch.rand(1, 3, 4, 32, generator=gen).cumsum(-1).to(card)
    return (lambda: chunk_scan(xdt, bm, cm, cum),
            lambda: registry.OPS[name](xdt, bm, cm, cum, None, False)[0],
            needed_flops(1, 3, 128, 32, 16, 8))


@pytest.mark.parametrize("name", ["triad", "matmul", "flash_attention_fwd",
                                  "ssd_chunk_scan_fwd"])
def test_each_op_is_seen_alone_and_launches_its_kernel_on_card(card, name):
    """FlopCounterMode and count_ops see the wrapper's call as the one op
    with its formula's FLOPs; the op's output is the wrapper's, bit for
    bit; the wrapper counts one launch."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels
    from repro_torch.analysis import count_ops
    wrapper, op, formula = _op_case(name, card)
    with FlopCounterMode(display=False) as counter:
        wrapper()
    assert {str(k): v for k, v in counter.get_flop_counts()[
        "Global"].items()} == {f"repro_torch.{name}": formula}
    module = count_ops(wrapper)
    assert [(o.kind, o.flops) for o in module.ops] == \
        [(f"repro_torch::{name}", formula)]
    kernels.reset_launch_counts()
    assert torch.equal(op(), wrapper())
    assert sum(kernels.launch_counts().values()) == 2


def test_measured_attribution_joins_the_flash_op_on_card(card):
    from repro_torch.models.transformer import StepConfig
    from repro_torch.models.workloads import build_workload
    from repro_torch.obs.attribution import Roofs, attribute
    w = build_workload("train_step", "granite_3_2b", device=card,
                       step=StepConfig(use_flash=True, flash_block_q=64,
                                       flash_block_k=64, remat=False))
    rep = attribute(w, Roofs(67e12, {"hbm": 3.35e12}))
    assert rep.mode == "measured" and rep.device_total_s > 0
    flash = [op for op in rep.ops
             if op.kind == "repro_torch::flash_attention_fwd"]
    assert flash and all(op.time_s and op.time_s > 0 for op in flash)
    assert rep.unattributed_frac < 0.05


def test_workload_audit_of_the_card_bound_registry(card):
    from repro_torch.lint.__main__ import run_workload_audit
    findings = [f for f in run_workload_audit("cuda")
                if f.severity != "info"]
    assert findings == [], [f.render() for f in findings]


def test_adamw_update_on_card_matches_the_host(card):
    """Three AdamW steps with the clip active on card tensors (bf16 and
    f32 leaves, nested keys), in place, each against the same step on the
    host and then restarted from the host's values (carried over steps,
    the ulps below add up): the f32 moments and leaf within rtol 1e-6
    plus 1e-6 of the leaf's largest magnitude (the two devices sum the
    norm's squares in other orders, so the clip scale may differ by an
    ulp), a bf16 leaf within one bf16 ulp (rtol 2**-7) plus that atol."""
    from repro_torch.models.params import flatten, map_tree
    from repro_torch.optim import adamw_update
    gen = torch.Generator().manual_seed(5)
    specs = {"layer": {"w": ((256, 1024), torch.bfloat16),
                       "w_f32": ((256, 1024), torch.float32)},
             "norm": ((256,), torch.bfloat16)}

    def draw(scale):
        return map_tree(lambda _, s: (torch.randn(s[0], generator=gen)
                                      * scale).to(s[1]), specs)

    def to_card(tree):
        return map_tree(lambda _, x: x.to(card, copy=True), tree)

    host = draw(0.05)
    host_opt = {"m": map_tree(lambda _, x: torch.zeros(x.shape), host),
                "v": map_tree(lambda _, x: torch.zeros(x.shape), host),
                "count": torch.zeros(())}
    dev, dev_opt = to_card(host), to_card(host_opt)
    for lr in (1e-2, 2e-2, 3e-2):
        g = draw(1.0)
        _, _, got = adamw_update(dev, to_card(g), dev_opt, lr)
        _, _, want = adamw_update(host, g, host_opt, lr)
        assert float(want["grad_norm"]) > 1.0
        torch.testing.assert_close(got["grad_norm"].cpu(),
                                   want["grad_norm"], rtol=1e-6, atol=0.0)
        got_all = flatten({"p": dev, **dev_opt})
        for path, want in flatten({"p": host, **host_opt}).items():
            out = got_all[path]
            assert out.dtype == want.dtype, path
            atol = 1e-6 * float(want.abs().max())
            rtol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 1e-6
            torch.testing.assert_close(out.cpu(), want, rtol=rtol,
                                       atol=atol)
            out.copy_(want)      # the next step starts from the host's


# ---------------------------------------------------------------------------
# Captured steps (repro_torch.graphs): the port's counterpart of jax.jit
# ---------------------------------------------------------------------------


def _kernel_calls(device):
    """(name, wrapper, call(inputs), inputs) of every kernel route, at
    small shapes: each call goes through the wrapper as a step does."""
    from repro_torch.kernels import flash_attention, matmul, triad
    from repro_torch.kernels.ssd import ssd_chunk_scan
    gen = torch.Generator().manual_seed(11)

    def randn(*shape, dtype=torch.float32):
        return _randn(gen, *shape, dtype=dtype, device=device)

    def qkv(d, dtype):
        return (randn(1, 4, 256, d, dtype=dtype),
                randn(1, 2, 256, d, dtype=dtype),
                randn(1, 2, 256, d, dtype=dtype))

    def attend(q, k, v):
        return flash_attention(q, k, v, bq=64, bk=64)

    a = torch.rand(4, 512, 16, generator=gen)
    dt = (0.01 + 0.2 * torch.rand(4, 512, 16, generator=gen)).to(device)
    return [
        ("triad", triad, lambda a, b: triad(a, b, gamma=3.0),
         (randn(1 << 16), randn(1 << 16))),
        ("matmul f32", matmul, lambda a, b: matmul(a, b),
         (randn(256, 192), randn(192, 320))),
        ("matmul bf16", matmul, lambda a, b: matmul(a, b),
         (randn(256, 192, dtype=torch.bfloat16),
          randn(192, 320, dtype=torch.bfloat16))),
        ("flash bf16 D=64", flash_attention, attend, qkv(64, torch.bfloat16)),
        ("flash bf16 D=128", flash_attention, attend,
         qkv(128, torch.bfloat16)),
        ("flash f32 D=64", flash_attention, attend, qkv(64, torch.float32)),
        ("flash f32 D=256", flash_attention, attend,
         qkv(256, torch.float32)),
        ("ssd", ssd_chunk_scan,
         lambda x, dt, a, b, c: ssd_chunk_scan(x, dt, a, b, c, chunk=128),
         (0.5 * randn(4, 512, 16, 8), dt, -a.mean((0, 1)).to(device),
          0.5 * randn(4, 512, 16), 0.5 * randn(4, 512, 16))),
    ]


@pytest.mark.parametrize("index", range(8))
def test_each_kernel_replays_from_a_captured_graph_on_card(card, index):
    """Every kernel route inside a CUDA graph (its launch function sets
    its attributes and launches on the capturing stream): three calls on
    new inputs, the first eager, the second captured and replayed, the
    third replayed, each equal to the eager wrapper on the same inputs,
    and one launch counted for each call."""
    from repro_torch import graphs
    name, wrapper, call, inputs = _kernel_calls(card)[index]
    step = graphs.captured(call)
    for i in range(3):
        args = tuple(x * (1 + 0.25 * i) for x in inputs)
        want = call(*args)
        before = wrapper.launches
        got = step(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, name
        assert torch.equal(got, want), (name, i)
    (entry,) = step._entries.values()
    assert entry.graph is not None and len(entry.launches) == 1, name
    step.release()


def _decode_runs(arch, card):
    """generate's decode on the card, eager and captured, from the same
    SMOKE weights and prompt: (tokens, logits, launches) of each."""
    from repro_torch import graphs, kernels
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import generate, serve_inputs
    from repro_torch.models import api
    from repro_torch.models.params import materialize
    import numpy as np
    cfg = get_smoke(arch)
    params = materialize(torch.Generator(device=card).manual_seed(0),
                         api.param_defs(cfg))
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (2, 16))).to(card)
    inputs = serve_inputs(cfg, 2, rng, card)
    out = {}
    for label in ("eager", "captured", "eager again"):
        kernels.reset_launch_counts()
        if label == "captured":
            run = generate(params, prompt, cfg, 10, inputs=inputs)
        else:
            with graphs.disabled():
                run = generate(params, prompt, cfg, 10, inputs=inputs)
        torch.cuda.synchronize()
        out[label] = (run["tokens"], run["logits"], kernels.launch_counts())
    return out


@pytest.mark.parametrize("arch", ["granite_3_2b", "granite_moe_1b_a400m",
                                  "llama_3_2_vision_11b", "whisper_base",
                                  "mamba2_130m", "zamba2_2_7b",
                                  "mixtral_8x22b", "gemma_2b"])
def test_captured_decode_gives_the_eager_tokens_on_card(card, arch):
    """Each family's SMOKE config through ``generate`` on the card: the
    decode steps replayed from a CUDA graph give the eager loop's tokens,
    their logits the eager ones within the spread of two eager runs
    (bitwise where the two eager runs are), and the same launches."""
    runs = _decode_runs(arch, card)
    e1, cap, e2 = runs["eager"], runs["captured"], runs["eager again"]
    assert torch.equal(cap[0], e1[0]), (cap[0], e1[0])
    spread = float((e1[1] - e2[1]).abs().max())
    assert float((cap[1] - e1[1]).abs().max()) <= spread
    assert cap[2] == e1[2] == e2[2]


@pytest.fixture
def one_rank():
    """No process group before or after the test (a process has one)."""
    from repro_torch.launch.mesh import release_world
    release_world()
    yield
    release_world()


def _train_runs(arch, mesh, card, use_flash):
    """Three train steps of ``arch``'s SMOKE config on the card, eager,
    captured and eager again, from the same weights and batches: each
    run's metrics, final parameters and optimizer state (whole tensors)
    and launches by kernel and route."""
    from repro_torch import graphs, kernels
    from repro_torch.configs import get_smoke
    from repro_torch.models import api
    from repro_torch.models.config import WorkloadShape
    from repro_torch.models.params import flatten, materialize
    from repro_torch.models.transformer import StepConfig
    from repro_torch.optim import adamw_init
    from repro_torch.train.steps import build_train_step
    import numpy as np
    cfg = get_smoke(arch)
    defs = api.param_defs(cfg)
    bundle = build_train_step(
        cfg, WorkloadShape("t", 128, 2, "train"), mesh,
        step_cfg=StepConfig(use_flash=use_flash, flash_block_q=64,
                            flash_block_k=64, remat=True, loss_chunk=64))
    rng = np.random.default_rng(3)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 128))).to(card)} for _ in range(3)]

    def whole(x):
        return x.full_tensor() if type(x).__name__ == "DTensor" else x

    out = {}
    for label in ("eager", "captured", "eager again"):
        params = materialize(torch.Generator(device=card).manual_seed(0),
                             defs)
        opt = adamw_init(defs, card)
        fn = bundle.jitted()
        kernels.reset_launch_counts()
        metrics = []
        with graphs.disabled() if label != "captured" else \
                contextlib.nullcontext():
            for i, batch in enumerate(batches):
                params, opt, mt = fn(params, opt, batch, i)
                metrics.append({k: whole(v).clone() for k, v in mt.items()})
        torch.cuda.synchronize()
        state = {f"p/{k}": whole(v) for k, v in flatten(params).items()}
        state.update({f"o/{k}": whole(v) for k, v in flatten(opt).items()})
        out[label] = (metrics, state, kernels.launch_counts(),
                      dict(kernels.flash_attention.route_launches))
        fn.release()
    return out


def _spread(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("sharded", [False, True], ids=["meshless", "world1"])
@pytest.mark.parametrize("arch,use_flash", [("granite_3_2b", True),
                                            ("mamba2_130m", False)])
def test_captured_train_steps_equal_the_eager_ones_on_card(
        card, one_rank, arch, use_flash, sharded):
    """Three train steps through ``StepBundle.jitted()`` on the card
    (granite's SMOKE config with the f32 flash kernel and remat, mamba2's
    with the SSD kernel; without a mesh and on the one-rank ``nccl`` host
    mesh), replayed from a CUDA graph from the second on, against the
    same steps run eagerly twice: every loss, global norm, parameter and
    moment within the spread of the two eager runs (that spread is 0 on
    an H100, so bitwise), and the same launches by kernel and route."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh() if sharded else None
    runs = _train_runs(arch, mesh, card, use_flash)
    e1, cap, e2 = runs["eager"], runs["captured"], runs["eager again"]
    for i, (a, b, c) in enumerate(zip(e1[0], cap[0], e2[0])):
        for k in a:
            assert _spread(b[k], a[k]) <= _spread(c[k], a[k]), (i, k)
    for k, v in e1[1].items():
        assert _spread(cap[1][k], v) <= _spread(e2[1][k], v), k
    assert cap[2] == e1[2] == e2[2] and cap[3] == e1[3] == e2[3]
    launched = cap[2]["flash_attention"] if use_flash else \
        cap[2]["ssd_chunk_scan"]
    assert launched > 0
