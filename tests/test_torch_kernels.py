"""The port's kernel wrappers on CPU tensors against the JAX package's
Pallas kernels in interpret mode: same numpy inputs, the shape/dtype
grids and tolerances of tests/test_kernels.py.

On the CPU a wrapper runs its plain PyTorch version, so these tests pin
the arithmetic the CUDA kernels are held to on the card (chip_smoke.py
and tests/test_torch_gpu.py), and that nothing is launched here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul import matmul as jax_matmul
from repro.kernels.triad import triad as jax_triad
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.matmul import (TILES, flops, matmul, matmul_ref,
                                        smem_bytes)
from repro_torch.kernels.triad import bytes_moved, triad, triad_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=3e-2, atol=3e-2) if name == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def _contraction_tol(name):
    return dict(rtol=3e-2, atol=3e-2) if name == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-4)


def _pair(x: np.ndarray, name: str):
    """The same float32 values in both frameworks, rounded to ``name``
    the same way (round to nearest even) on both sides."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (300, 450, 200),
                                   (1024, 256, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas_interpret(m, n, k, dtype):
    rng = np.random.default_rng(m * 7 + n * 3 + k)
    a_np = rng.standard_normal((m, k), dtype=np.float32)
    b_np = rng.standard_normal((k, n), dtype=np.float32)
    ja, ta = _pair(a_np, dtype)
    jb, tb = _pair(b_np, dtype)
    want = jax_matmul(ja, jb, bm=128, bn=128, bk=64, interpret=True)
    got = matmul(ta, tb, bm=128, bn=128, bk=16)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **_contraction_tol(dtype))


@pytest.mark.parametrize("tile", TILES)
def test_matmul_every_tile_takes_the_plain_path(tile):
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((96, 40), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((40, 72), dtype=np.float32))
    bm, bn, bk = tile
    torch.testing.assert_close(matmul(a, b, bm=bm, bn=bn, bk=bk),
                               matmul_ref(a, b), rtol=0, atol=0)


@pytest.mark.parametrize("n", [1024, 4096, 100_000, 1_048_576 + 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_triad_matches_pallas_interpret(n, dtype):
    rng = np.random.default_rng(n)
    ja, ta = _pair(rng.standard_normal(n, dtype=np.float32), dtype)
    jb, tb = _pair(rng.standard_normal(n, dtype=np.float32), dtype)
    want = jax_triad(ja, jb, gamma=3.0, br=8, interpret=True)
    got = triad(ta, tb, gamma=3.0)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (n,)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


def test_smem_bytes_formula_and_table_fits_static_limit():
    # (bm*bk + bk*bn) float32 words staged per block
    assert smem_bytes(128, 128, 32) == (128 * 32 + 32 * 128) * 4
    assert smem_bytes(64, 128, 8) == (64 * 8 + 8 * 128) * 4
    assert len(TILES) == 12 and len(set(TILES)) == 12
    assert max(smem_bytes(*t) for t in TILES) <= 48 * 1024


def test_work_terms_match_the_reference():
    from repro.kernels.matmul import flops as jax_flops
    from repro.kernels.triad import bytes_moved as jax_bytes
    assert flops(300, 450, 200) == jax_flops(300, 450, 200)
    assert bytes_moved(1000, 2) == jax_bytes(1000, 2)


def test_tile_outside_the_table_raises():
    a = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="not in the compiled table"):
        matmul(a, a, bm=256, bn=128, bk=16)
    with pytest.raises(ValueError, match="not in the compiled table"):
        matmul.resolve((a, a), bm=32, bn=32, bk=8)


def test_wrappers_validate_operands():
    with pytest.raises(ValueError):
        matmul(torch.zeros(4, 5), torch.zeros(4, 5))
    with pytest.raises(TypeError):
        matmul(torch.zeros(4, 4, dtype=torch.float64),
               torch.zeros(4, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        matmul(torch.zeros(8, 8).t(), torch.zeros(8, 8))
    with pytest.raises(ValueError):
        triad(torch.zeros(4), torch.zeros(5))
    with pytest.raises(TypeError):
        triad(torch.zeros(4), torch.zeros(4, dtype=torch.bfloat16))


def test_cpu_calls_launch_nothing():
    reset_launch_counts()
    a = torch.ones(64, 64)
    matmul(a, a, bm=64, bn=64, bk=8)
    matmul.resolve((a, a), bm=64, bn=64, bk=8)(a, a)
    triad(a[0], a[1])
    triad.resolve((a[0], a[1]), gamma=2.0)(a[0], a[1])
    assert launch_counts() == {"matmul": 0, "triad": 0,
                               "flash_attention": 0}


def test_triad_ref_is_the_plain_formula():
    a = torch.arange(5, dtype=torch.float32)
    b = torch.ones(5)
    torch.testing.assert_close(triad_ref(a, b, 3.0), a + 3.0)
    torch.testing.assert_close(triad(a, b, gamma=0.5), a + 0.5)


def test_tile_table_matches_the_cuda_instantiations():
    import re

    from repro_torch.kernels import build
    src = (build.CSRC / "matmul.cu").read_text()
    compiled = {tuple(map(int, t)) for t in re.findall(
        r"RT_MATMUL\(NAME, T, (\d+), (\d+), (\d+)\)", src)}
    assert compiled == set(TILES)
    assert "RT_MATMUL_TILES(f32, float)" in src
    assert "RT_MATMUL_TILES(bf16, __nv_bfloat16)" in src
    triad_src = (build.CSRC / "triad.cu").read_text()
    assert "int rt_triad_f32(" in triad_src
    assert "int rt_triad_bf16(" in triad_src


def test_build_is_keyed_by_the_sources_and_needs_nvcc(monkeypatch, tmp_path):
    import shutil

    from repro_torch.kernels import build
    key = build.source_hash()
    assert key == build.source_hash() and len(key) == 16
    assert build.library_path() == build.BUILD_ROOT / key / build.LIB_NAME
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
