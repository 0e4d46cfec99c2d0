"""The port's flash attention against the JAX package's: the same numpy
inputs through ``repro.kernels.flash_attention.flash_attention`` (Pallas
in interpret mode, as ``tests/test_kernels.py`` runs it) and through the
port's ``flash_attention`` on CPU tensors (its plain path through the
padding and the autograd function). Outputs are held at the reference
tests' tolerances (rtol = atol = 2e-5 in f32, 3e-2 in bf16); gradients
of sum(out * g) against ``jax.vjp`` through the JAX custom VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import (SM90_TILES, attention_ref,
                                                 flash_attention, flops,
                                                 padded_blocks, physical_tile)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# Both backward passes differentiate the same dense f32 reference; they
# differ only in the summation order of the two frameworks' einsums.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _qkv(seed: int, b: int, hq: int, hkv: int, s: int, d: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d), dtype=np.float32),
            rng.standard_normal((b, hkv, s, d), dtype=np.float32),
            rng.standard_normal((b, hkv, s, d), dtype=np.float32))


def _both(arrays, dtype=torch.float32):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ([torch.from_numpy(a).to(dtype) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


def _close(got: torch.Tensor, want, tol) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_causal_matches_reference(hq, hkv, causal):
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(hq * 10 + hkv, 2, hq, hkv, 256,
                                            64))
    got = flash_attention(tq, tk, tv, causal=causal, bq=64, bk=64)
    want = jax_flash(jq, jk, jv, causal=causal, bq=64, bk=64, interpret=True)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("window", [32, 96, 256])
def test_sliding_window_matches_reference(window):
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(window, 1, 4, 2, 256, 32))
    got = flash_attention(tq, tk, tv, causal=True, window=window, bq=64,
                          bk=64)
    want = jax_flash(jq, jk, jv, causal=True, window=window, bq=64, bk=64,
                     interpret=True)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("s", [100, 200, 250])
def test_padded_lengths_match_reference(s):
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(s, 1, 4, 4, s, 32))
    got = flash_attention(tq, tk, tv, causal=True, bq=64, bk=64)
    want = jax_flash(jq, jk, jv, causal=True, bq=64, bk=64, interpret=True)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("s", [100, 200, 250])
def test_non_causal_padding_masks_the_padded_keys(s):
    """The Pallas path lets zero-padded keys into a non-causal softmax;
    the port masks them, so it is held against the dense reference."""
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(s + 1, 1, 4, 2, s, 32))
    got = flash_attention(tq, tk, tv, causal=False, bq=64, bk=64)
    _close(got, jax_attention_ref(jq, jk, jv, causal=False), F32_TOL)
    _close(got, attention_ref(tq, tk, tv, causal=False), F32_TOL)
    # from S = 128 up the case pads; below it the block is S itself
    assert (padded_blocks(s, 64, 64)[2] > s) == (s >= 128)


def test_bf16_matches_reference():
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(77, 1, 4, 4, 128, 64),
                                       torch.bfloat16)
    got = flash_attention(tq, tk, tv, causal=True, bq=128, bk=128)
    assert got.dtype == torch.bfloat16
    want = jax_flash(jq, jk, jv, causal=True, bq=128, bk=128, interpret=True)
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("case", [
    dict(shape=(2, 8, 2, 256, 64), causal=True, window=None),
    dict(shape=(1, 4, 2, 256, 32), causal=True, window=96),
    dict(shape=(1, 4, 4, 200, 32), causal=True, window=None),
    dict(shape=(1, 4, 1, 128, 16), causal=False, window=None),
], ids=["gqa", "window", "padded", "mqa-noncausal"])
def test_gradients_match_jax_vjp(case):
    b, hq, hkv, s, d = case["shape"]
    arrays = _qkv(s + hq, b, hq, hkv, s, d)
    g = np.random.default_rng(5).standard_normal((b, hq, s, d),
                                                 dtype=np.float32)
    (tq, tk, tv), (jq, jk, jv) = _both(arrays)
    kw = dict(causal=case["causal"], window=case["window"])
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    out = flash_attention(*leaves, bq=64, bk=64, **kw)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, bq=64, bk=64,
                                                interpret=True, **kw),
                     jq, jk, jv)
    for mine, theirs in zip(got, vjp(jnp.asarray(g))):
        _close(mine, theirs, GRAD_TOL)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    (tq, tk, tv), _ = _both(_qkv(3, 1, 4, 2, 96, 16))
    reset_launch_counts()
    out = flash_attention(tq, tk, tv, causal=True, bq=64, bk=64)
    assert launch_counts()["flash_attention"] == 0
    dense = flash_attention(tq, tk, tv, causal=True, use_kernel=False)
    torch.testing.assert_close(out, dense, **F32_TOL)
    torch.testing.assert_close(dense, attention_ref(tq, tk, tv, causal=True),
                               rtol=0, atol=0)


@pytest.mark.parametrize("s,bq,bk,want", [
    (64, 512, 512, (64, 64, 64)),        # below 128: one block of S
    (100, 64, 64, (100, 100, 100)),
    (200, 64, 64, (64, 64, 256)),
    (300, 256, 64, (256, 64, 512)),
    (4096, 128, 64, (128, 64, 4096)),
])
def test_padding_rule_of_the_reference(s, bq, bk, want):
    assert padded_blocks(s, bq, bk) == want


@pytest.mark.parametrize("bq,bk", [(0, 64), (64, -1)])
def test_non_positive_blocks_raise(bq, bk):
    (tq, tk, tv), _ = _both(_qkv(4, 1, 2, 2, 32, 16))
    with pytest.raises(ValueError, match="positive"):
        flash_attention(tq, tk, tv, bq=bq, bk=bk)


def test_flops_formula_matches_reference():
    from repro.kernels.flash_attention import flops as jax_flops
    for causal in (True, False):
        assert flops(1, 32, 4096, 64, causal) == \
            jax_flops(1, 32, 4096, 64, causal)


QUAD = ((64, 64), (64, 128), (128, 64), (128, 128))


@pytest.mark.parametrize("bq,bk,tiles,want", [
    (64, 64, QUAD, (64, 64)),
    (64, 128, QUAD, (64, 128)),
    (128, 64, QUAD, (128, 64)),
    (128, 128, QUAD, (128, 128)),
    (512, 256, QUAD, (128, 128)),            # clamped above 128
    (256, 64, QUAD, (128, 64)),
    (96, 200, QUAD, (64, 128)),              # sides outside the table
    (100, 100, QUAD, (64, 64)),              # a short sequence's block
    (32, 16, QUAD, (64, 64)),                # below every tile: the smallest
    (128, 128, ((64, 64), (128, 64)), (128, 64)),   # D = 256: kv 64 only
    (512, 512, ((64, 64), (128, 64)), (128, 64)),
    (64, 512, ((64, 64), (128, 64)), (64, 64)),
])
def test_physical_tile_rule(bq, bk, tiles, want):
    assert physical_tile(bq, bk, tiles) == want


def test_physical_tile_rule_raises_without_a_fitting_tile():
    with pytest.raises(ValueError, match="no compiled flash tile"):
        physical_tile(64, 64, ((64, 128), (128, 64)))
    with pytest.raises(ValueError, match="no compiled flash tiles"):
        physical_tile(64, 64, ())


@pytest.mark.parametrize("d", [64, 80])
def test_quick_space_tiles_are_four_kernels(d):
    from repro_torch.bench.common import model_step_space
    pairs = {(c["flash_block_q"], c["flash_block_k"])
             for c in model_step_space(True).configs()}
    assert {physical_tile(bq, bk, SM90_TILES[d]) for bq, bk in pairs} == \
        set(QUAD)


def test_sm90_tile_table_matches_the_cuda_source():
    import re

    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention_sm90.cu").read_text()
    table = src[src.index("#define RT_FLASH_SM90_TILES(X)"):]
    table = table[:table.index("\n\n")]
    compiled = [tuple(map(int, t)) for t in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", table)]
    assert len(compiled) == len(set(compiled))
    assert set(compiled) == {(d, qt, kt) for d, tiles in SM90_TILES.items()
                             for qt, kt in tiles}
    assert "RT_FLASH_SM90_TILES(RT_FLASH_SM90)" in src
    assert "rt_flash_attention_bf16_d##D##_q##QT##_k##KT" in src
    # every head dim of the f32 kernel has a bf16 kernel too
    f32 = (build.CSRC / "flash_attention.cu").read_text()
    f32_table = f32[f32.index("#define RT_FLASH_TILES(X)"):]
    f32_table = f32_table[:f32_table.index("\n\n")]
    f32_dims = {int(d) for d in re.findall(r"X\((\d+),", f32_table)}
    assert f32_dims == set(SM90_TILES)
    assert "RT_FLASH_TILES(RT_FLASH_F32)" in f32 and "BF16" not in f32


def test_cpu_calls_count_no_route():
    (tq, tk, tv), _ = _both(_qkv(5, 1, 4, 2, 64, 32), torch.bfloat16)
    reset_launch_counts()
    flash_attention(tq, tk, tv, bq=64, bk=64)
    assert flash_attention.route_launches == {"tensor_cores": 0,
                                              "cuda_cores": 0}
