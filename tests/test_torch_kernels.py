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
from repro_torch.kernels.matmul import (BF16_TILES, F32_STAGES,
                                        ROUTE_TILES, TILES, flops, matmul,
                                        matmul_ref, route, smem_bytes, tiles,
                                        tma_operand)
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
    # bf16 takes the tensor-core route at the reference's own tile; f32
    # the CUDA-core route, whose table has no bk = 64
    bk = 64 if dtype == "bfloat16" else 16
    got = matmul(ta, tb, bm=128, bn=128, bk=bk)
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


@pytest.mark.parametrize("tile", BF16_TILES)
def test_matmul_every_bf16_tile_takes_the_plain_path(tile):
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((96, 40), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((40, 72), dtype=np.float32))
    a, b = a.bfloat16(), b.bfloat16()
    bm, bn, bk = tile
    got = matmul(a, b, bm=bm, bn=bn, bk=bk)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, matmul_ref(a, b), rtol=0, atol=0)


def test_routes_by_dtype():
    assert route(torch.float32) == "cuda_cores"
    assert route(torch.bfloat16) == "tensor_cores"
    assert tiles(torch.float32) == TILES == ROUTE_TILES["cuda_cores"]
    assert tiles(torch.bfloat16) == BF16_TILES == \
        ROUTE_TILES["tensor_cores"]
    assert matmul.route_launches.keys() == ROUTE_TILES.keys()
    with pytest.raises(TypeError):
        route(torch.float16)
    # a tile not given is the route's default: f32 (128, 128, 16) is not
    # in the bf16 table, the reference's (128, 128, 64) is
    a = torch.ones(8, 8, dtype=torch.bfloat16)
    assert matmul(a, a).dtype == torch.bfloat16
    assert (128, 128, 64) in BF16_TILES and (128, 128, 16) in TILES


@pytest.mark.parametrize("shape,offset", [((5, 13), 0), ((7, 16), 0),
                                          ((7, 16), 1), ((3, 0), 0)])
def test_tma_operand_rounds_the_row_stride(shape, offset):
    # the tensor-core kernel's TMA loads want rows a multiple of 16 bytes
    # apart from a 16-byte aligned start: an operand that is not so is
    # copied into a buffer whose row stride is rounded up to 8 elements
    rows, cols = shape
    x = torch.empty(rows * cols + offset, dtype=torch.bfloat16)[offset:]
    x = x.view(rows, cols).copy_(
        torch.arange(rows * cols).reshape(rows, cols))
    got, ld = tma_operand(x)
    assert ld == -(-cols // 8) * 8 and ld % 8 == 0
    assert got.shape == (rows, ld) and got.data_ptr() % 16 == 0
    assert torch.equal(got[:, :cols], x)
    assert (got is x) == (ld == cols and x.data_ptr() % 16 == 0)


@pytest.mark.parametrize("shape,offset", [((5, 13), 0), ((7, 16), 0),
                                          ((7, 16), 1), ((7, 16), 2),
                                          ((33, 65), 0), ((3, 0), 0)])
def test_tma_operand_rounds_the_row_stride_f32(shape, offset):
    # the f32 kernel's TMA loads want the same 16 bytes: rows a multiple
    # of 4 float32 elements apart from a 16-byte aligned start; a sliced
    # view that starts 4 or 8 bytes in is copied even when its rows are
    rows, cols = shape
    x = torch.empty(rows * cols + offset, dtype=torch.float32)[offset:]
    x = x.view(rows, cols).copy_(
        torch.arange(rows * cols, dtype=torch.float32).reshape(rows, cols))
    got, ld = tma_operand(x)
    assert ld == -(-cols // 4) * 4 and ld % 4 == 0
    assert got.shape == (rows, ld) and got.data_ptr() % 16 == 0
    assert torch.equal(got[:, :cols], x)
    assert (got is x) == (ld == cols and x.data_ptr() % 16 == 0)
    if offset:
        assert got is not x


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
    # 1024 bytes of alignment, then three stages of bm x bk A and bk x bn
    # B float32 words and two 8-byte mbarriers each; the table needs the
    # H100's opt-in limit (232,448 bytes), not the static 48 KiB
    assert F32_STAGES == 3
    assert smem_bytes(128, 128, 32) == \
        1024 + 3 * ((128 * 32 + 32 * 128) * 4 + 16) == 99376
    assert smem_bytes(64, 128, 8) == 1024 + 3 * ((64 * 8 + 8 * 128) * 4 + 16)
    assert smem_bytes(64, 64, 8) == 13360
    assert len(TILES) == 12 and len(set(TILES)) == 12
    assert max(smem_bytes(*t) for t in TILES) <= 232448
    assert max(smem_bytes(*t) for t in TILES) > 48 * 1024


def test_work_terms_match_the_reference():
    from repro.kernels.matmul import flops as jax_flops
    from repro.kernels.triad import bytes_moved as jax_bytes
    assert flops(300, 450, 200) == jax_flops(300, 450, 200)
    assert bytes_moved(1000, 2) == jax_bytes(1000, 2)


def test_bf16_smem_bytes_formula_and_table_fits_the_opt_in_limit():
    # 1024 bytes of alignment, then the deepest ring of (bm bk + bk bn)
    # bf16 stages and two 8-byte mbarriers each that fits 232,448 bytes
    stage = (128 * 64 + 64 * 256) * 2 + 16
    assert smem_bytes(128, 256, 64, torch.bfloat16) == \
        1024 + 4 * stage == 197696
    assert len(BF16_TILES) == len(set(BF16_TILES)) >= 6
    for t in BF16_TILES:
        st = (t[0] * t[2] + t[2] * t[1]) * 2 + 16
        got = smem_bytes(*t, torch.bfloat16)
        assert got <= 232448 < got + st      # no deeper ring fits
        assert (got - 1024) // st >= 2
    assert smem_bytes(128, 128, 32) == smem_bytes(128, 128, 32,
                                                  torch.float32)


@pytest.mark.parametrize("dtype,tile", [
    (torch.float32, (128, 128, 64)), (torch.float32, (256, 128, 16)),
    (torch.bfloat16, (128, 128, 16)), (torch.bfloat16, (256, 256, 64))])
def test_tile_outside_its_dtype_table_raises(dtype, tile):
    a = torch.zeros(8, 8, dtype=dtype)
    bm, bn, bk = tile
    with pytest.raises(ValueError, match="not in the compiled table"):
        matmul(a, a, bm=bm, bn=bn, bk=bk)
    with pytest.raises(ValueError, match="not in the compiled table"):
        matmul.resolve((a, a), bm=bm, bn=bn, bk=bk)


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
                               "flash_attention": 0, "ssd_chunk_scan": 0}


def test_triad_ref_is_the_plain_formula():
    a = torch.arange(5, dtype=torch.float32)
    b = torch.ones(5)
    torch.testing.assert_close(triad_ref(a, b, 3.0), a + 3.0)
    torch.testing.assert_close(triad(a, b, gamma=0.5), a + 0.5)


def test_tile_table_matches_the_cuda_instantiations():
    import re

    from repro_torch.kernels import build
    # the replaced CUDA-core design, outside the library, still compiles
    # every tile of TILES in f32 and bf16 (timed beside both kernels)
    assert not (build.CSRC / "matmul.cu").exists()
    assert build.CSRC / "baseline" / "matmul_cuda_cores.cu" not in \
        build._sources()
    src = (build.CSRC / "baseline" / "matmul_cuda_cores.cu").read_text()
    compiled = {tuple(map(int, t)) for t in re.findall(
        r"RT_MATMUL\(NAME, T, (\d+), (\d+), (\d+)\)", src)}
    assert compiled == set(TILES)
    assert "RT_MATMUL_TILES(f32, float)" in src
    assert "RT_MATMUL_TILES(bf16, __nv_bfloat16)" in src
    sm90 = (build.CSRC / "matmul_sm90.cu").read_text()
    table = sm90.split("#define RT_MATMUL_SM90_TILES(X)", 1)[1]
    table = table.split("\n\n", 1)[0]
    compiled = [tuple(map(int, t)) for t in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", table)]
    assert compiled == list(BF16_TILES)
    assert "RT_MATMUL_SM90_TILES(RT_MATMUL_SM90)" in sm90
    triad_src = (build.CSRC / "triad.cu").read_text()
    assert "int rt_triad_f32(" in triad_src
    assert "int rt_triad_bf16(" in triad_src


def test_f32_tile_table_matches_the_sm90_source():
    import re

    from repro_torch.kernels import build
    src = (build.CSRC / "matmul_f32_sm90.cu").read_text()
    assert build.CSRC / "matmul_f32_sm90.cu" in build._sources()
    table = src.split("#define RT_MATMUL_F32_SM90_TILES(X)", 1)[1]
    table = table.split("\n\n", 1)[0]
    compiled = [tuple(map(int, t)) for t in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", table)]
    assert compiled == list(TILES)
    assert "RT_MATMUL_F32_SM90_TILES(RT_MATMUL_F32_SM90)" in src
    assert "rt_matmul_f32_sm90_##BM##x##BN##x##BK" in src
    assert re.search(r"constexpr int kStages = (\d+);", src).group(1) == \
        str(F32_STAGES)


def test_f32_kernel_source_is_hopper_code():
    # operands by TMA on mbarriers from a producer, no __syncthreads in the
    # k loop (one, after the barriers' init), no non-bulk cp.async, and
    # every source built for sm_90a
    import re

    from repro_torch.kernels import build
    src = (build.CSRC / "matmul_f32_sm90.cu").read_text()
    code = "\n".join(line.split("//", 1)[0] for line in src.splitlines())
    assert "tma_load_2d(" in code and "mbar_expect_tx(" in code
    assert "mbar_wait(full" in code and "mbar_arrive(empty" in code
    assert "set_max_regs_dec<" in code and "set_max_regs_inc<" in code
    assert code.count("__syncthreads()") == 1
    assert code.index("__syncthreads()") < code.index("for (int t = 0;")
    assert not re.search(r"cp\.async(?!\.bulk)", code)
    assert "cp.async.bulk.tensor" in (build.CSRC / "hopper.cuh").read_text()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


GEMM_PROBE_VARIANTS = ["no_loads", "no_fma", "tile_8x16", "a_reads_16B",
                       "a_reads_4B", "four_stages", "lanes_8x4", "budget_136",
                       "first_build"]


@pytest.mark.parametrize("variant", GEMM_PROBE_VARIANTS)
def test_gemm_probe_edits_still_match_the_kernel_source(variant):
    """Each variant of ``bench/gemm_probe.py`` is an edit of
    ``csrc/matmul_f32_sm90.cu`` that must find its text exactly once, or
    the probe would measure the shipped kernel under another name."""
    from repro_torch.bench.gemm_probe import EDITS, variant_source
    assert set(EDITS) - {"shipped"} == set(GEMM_PROBE_VARIANTS)
    shipped = variant_source("shipped")
    edited = variant_source(variant)
    assert edited != shipped
    for old, new in EDITS[variant]:
        assert new in edited and old not in edited


def test_gemm_probe_reads_the_ptxas_log():
    from repro_torch.bench.gemm_probe import ptxas_rows
    name = "_ZN12_GLOBAL__N_122matmul_f32_sm90_kernelILi128ELi64ELi16EEEv"
    log = (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {name}\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 224 registers, used 1 barriers\n")
    assert ptxas_rows(log) == {(128, 64, 16): {
        "registers": 224, "spill_stores": 8, "spill_loads": 4}}


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
