"""The port's benchmark layer against ``benchmarks/common.py``: same work
terms, same seeds and operands, same spaces and settings; the executable
cache's resolve-once keying; and the ``python -m repro_torch.tune`` CLI
end to end on the host."""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.common as ref_common
from repro_torch.bench import common
from repro_torch.core import (ExecutableCache, TensorSpec, Tuner, grid,
                              load_trials)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.triad import triad

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n,m,k", [(256, 512, 64), (500, 1000, 2048)])
def test_dgemm_operands_equal_the_reference(n, m, k):
    seed = common.dgemm_seed(n, m, k, 3)
    assert seed == (n * 1_000_003 + m * 10_007 + k * 101 + 3) % (2 ** 31)
    a, b = common.dgemm_data(n, m, k, seed, device="cpu")
    ra, rb = ref_common._dgemm_data(n, m, k, seed, jnp.float32)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb))


@pytest.mark.parametrize("n_bytes", [2 ** 14, 2 ** 22, 2 ** 28])
@pytest.mark.parametrize("dtypes", [(torch.float32, jnp.float32),
                                    (torch.bfloat16, jnp.bfloat16)])
def test_work_terms_equal_the_reference(n_bytes, dtypes):
    tdt, jdt = dtypes
    assert common.triad_length(n_bytes, tdt) == \
        ref_common.triad_length(n_bytes, jdt)
    assert common.triad_moved_bytes(n_bytes, tdt) == \
        ref_common.triad_moved_bytes(n_bytes, jdt)
    assert common.dgemm_flops(4000, 2000, n_bytes) == \
        ref_common.dgemm_flops(4000, 2000, n_bytes)


def test_triad_data_is_seeded_by_length():
    a1, b1 = common.triad_data(5000, device="cpu")
    a2, b2 = common.triad_data(5000, device="cpu")
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    rng = np.random.default_rng(5000)
    np.testing.assert_array_equal(
        a1.numpy(), rng.standard_normal(5000, dtype=np.float32))


@pytest.mark.parametrize("quick", [True, False])
def test_spaces_and_settings_equal_the_reference(quick):
    ours, theirs = common.dgemm_space(quick), ref_common.dgemm_space(quick)
    assert list(ours.configs()) == list(theirs.configs())
    import repro_torch.core as port
    from repro.core import settings_key as ref_key
    assert port.settings_key(common.paper_settings(quick)) == \
        ref_key(ref_common.paper_settings(quick))


def test_gemm_tiled_space_constraints():
    space = common.gemm_tiled_space()
    assert space.cardinality == 12    # every table tile fits the opt-in limit
    tight = common.gemm_tiled_space(smem_limit=16 * 1024)
    from repro_torch.kernels.matmul import smem_bytes
    assert all(smem_bytes(c["bm"], c["bn"], c["bk"]) <= 16 * 1024
               for c in tight.configs())
    assert 0 < tight.cardinality < 12
    assert common.GEMM_TILED_SHAPE == {"m": 4096, "n": 2048, "k": 6144}


def test_block_smem_limit_is_the_opt_in_limit():
    # the host's plain path has no limit: it takes the H100's, so the CPU
    # space keeps every tile; on a card the property is read
    assert common.block_smem_limit("cpu") == common.SM90_SMEM_OPTIN_BYTES
    assert common.SM90_SMEM_OPTIN_BYTES == 232448
    assert common.gemm_tiled_space(
        common.block_smem_limit("cpu")).cardinality == 12


def test_gemm_tiled_benchmark_tunes_on_the_host(monkeypatch):
    monkeypatch.setattr(common, "GEMM_TILED_SHAPE",
                        {"m": 128, "n": 96, "k": 32})
    shapes = []
    real = common.gemm_tiled_invocation_factory

    def spy(bm, bn, bk, data, **kw):
        a, b = data()
        shapes.append((a.shape, b.shape, id(a)))
        return real(bm, bn, bk, data, **kw)

    monkeypatch.setattr(common, "gemm_tiled_invocation_factory", spy)
    reset_launch_counts()
    settings = common.paper_settings(True)
    result = Tuner(common.gemm_tiled_space(), settings).tune(
        common.gemm_tiled_benchmark("cpu"), pipeline="off")
    assert len(result.trials) == 12 and result.best_score > 0
    # one (m, k) @ (k, n) draw, shared by every tile
    assert {(a, b) for a, b, _ in shapes} == {((128, 32), (32, 96))}
    assert len({i for _, _, i in shapes}) == 1
    assert launch_counts() == {"matmul": 0, "triad": 0,
                               "flash_attention": 0, "ssd_chunk_scan": 0}


def test_exec_cache_resolves_each_tile_once():
    cache = ExecutableCache(fingerprint="fp")
    specs = (TensorSpec((64, 32), torch.float32, "cpu"),
             TensorSpec((32, 16), torch.float32, "cpu"))
    f1 = cache.compile(matmul, specs, static={"bm": 64, "bn": 64, "bk": 8})
    f2 = cache.compile(matmul, specs, static={"bm": 64, "bn": 64, "bk": 8})
    f3 = cache.compile(matmul, specs, static={"bm": 128, "bn": 64, "bk": 8})
    assert f1 is f2 and f1 is not f3
    stats = cache.stats
    assert (stats.hits, stats.misses, stats.compiles) == (1, 2, 2)
    a = torch.ones(64, 32)
    torch.testing.assert_close(f1(a, torch.ones(32, 16)),
                               torch.full((64, 16), 32.0))
    assert cache.compile(torch.matmul, specs) is torch.matmul
    with pytest.raises(ValueError):
        cache.compile(matmul, specs, static={"bm": 96, "bn": 64, "bk": 8})
    g = cache.compile(triad, (torch.ones(4), torch.ones(4)),
                      static={"gamma": 2.0})
    torch.testing.assert_close(g(torch.ones(4), torch.ones(4)),
                               torch.full((4,), 3.0))


def test_benchmarks_run_on_the_host_without_launches():
    reset_launch_counts()
    settings = common.paper_settings(True)
    tri = Tuner(grid(n_bytes=(2 ** 16,)), settings).tune(
        common.triad_benchmark("cpu"))
    dg = Tuner(grid(n=(64,), m=(64,), k=(32,)), settings).tune(
        common.dgemm_benchmark("cpu"))
    assert tri.best_score > 0 and dg.best_score > 0
    assert launch_counts() == {"matmul": 0, "triad": 0,
                               "flash_attention": 0, "ssd_chunk_scan": 0}


def _tune_cli(tmp_path, *args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", "--cache-dir",
         str(tmp_path), *args], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=240)


def test_cli_synthetic_session_resumes(tmp_path):
    args = ("--session", "s", "--benchmark", "synthetic", "--device", "cpu")
    first = _tune_cli(tmp_path, *args)
    assert first.returncode == 0, first.stderr
    assert "best      : {'x': 7}  score=100.0" in first.stdout
    assert "fingerprint: cpu:" in first.stdout
    assert ("kernels   : flash_attention=0  matmul=0  ssd_chunk_scan=0  triad=0 launches"
            in first.stdout)
    again = _tune_cli(tmp_path, *args)
    assert again.returncode == 0, again.stderr
    assert "cached     : 12 trials" in again.stdout
    assert "cached=12" in again.stdout


def test_cli_triad_quick_on_the_host_with_report(tmp_path):
    base = ("--session", "s", "--device", "cpu")
    tri = _tune_cli(tmp_path, *base, "--benchmark", "triad")
    assert tri.returncode == 0, tri.stderr
    assert "trials    : 3  cached=0  pruned=0" in tri.stdout
    dg = _tune_cli(tmp_path, *base, "--benchmark", "dgemm", "--strategy",
                   "random", "--budget", "2", "--seed", "0", "--report")
    assert dg.returncode == 0, dg.stderr
    assert "peak compute F_p (dgemm)" in dg.stdout
    assert dg.stdout.count("bandwidth B_a mem[") == 3


def test_roofline_model_dgemm_space_follows_the_device(monkeypatch,
                                                      tmp_path):
    from repro_torch.bench import roofline_model
    from repro_torch.core import RandomSearchStrategy
    settings = common.paper_settings(True)
    card = roofline_model.dgemm_tuner(True, "cuda", settings)
    assert isinstance(card.strategy, RandomSearchStrategy)
    assert card.strategy.budget == roofline_model.CARD_DGEMM_BUDGET == 16
    assert list(card.space.configs()) == \
        list(common.dgemm_space(False).configs())
    host = roofline_model.dgemm_tuner(True, "cpu", settings)
    assert not isinstance(host.strategy, RandomSearchStrategy)
    assert list(host.space.configs()) == \
        list(common.dgemm_space(True).configs())
    # the host run end to end, at a small DGEMM corner and TRIAD sizes
    monkeypatch.setattr(roofline_model, "dgemm_space",
                        lambda quick: grid(n=(64, 128), m=(64,), k=(32,)))
    monkeypatch.setattr(roofline_model, "TRIAD_SIZES",
                        {"cache": 1 << 16, "dram": 1 << 18})
    res = roofline_model.run(quick=True, cache_dir=str(tmp_path),
                             device="cpu")
    report = next(r for r in res["reports"]
                  if r.fingerprint == res["fingerprint"])
    assert "peak compute F_p (dgemm)" in res["markdown"]
    assert len(report.bandwidths) == 2 and report.dgemm.score > 0
    trials = load_trials(tmp_path / "roofline.jsonl")
    assert sorted(t.benchmark for t in trials) == \
        ["dgemm", "dgemm", "triad", "triad"]
