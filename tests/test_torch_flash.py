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
from repro_torch.kernels.flash_attention import (ROUTE_TILES, SM90_TILES,
                                                 TF32X3_D256_TILES,
                                                 TF32X3_TILES, attention_ref,
                                                 flash_attention, flops,
                                                 padded_blocks, physical_tile,
                                                 route)

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


@pytest.mark.parametrize("window", [None, 64])
def test_head_dim_256_mqa_matches_reference(window):
    """gemma-2b's attention shape cut to size: head dim 256, one kv head
    for four query heads (the f32 D = 256 route's operands), causal, with
    and without a window, padded from S = 160."""
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(256 + (window or 0), 1, 4, 1,
                                            160, 256))
    got = flash_attention(tq, tk, tv, causal=True, window=window, bq=64,
                          bk=64)
    want = jax_flash(jq, jk, jv, causal=True, window=window, bq=64, bk=64,
                     interpret=True)
    _close(got, want, F32_TOL)


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
    (64, 64, ((64, 32), (128, 16)), (64, 32)),
    (128, 64, ((64, 32), (128, 16)), (128, 16)),    # equal areas: more q
    (128, 128, ((64, 32),), (64, 32)),              # f32 D = 256
    (32, 16, ((64, 32),), (64, 32)),
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


def _compiled_tiles(source: str, macro: str) -> list[tuple[int, ...]]:
    """The (D, QT, KT) entries of a tile-table macro of a CUDA source."""
    import re

    from repro_torch.kernels import build
    src = (build.CSRC / source).read_text()
    table = src[src.index(f"#define {macro}(X)"):]
    table = table[:table.index("\n\n")]
    return [tuple(map(int, t)) for t in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", table)]


def test_sm90_tile_table_matches_the_cuda_source():
    import re

    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention_sm90.cu").read_text()
    compiled = _compiled_tiles("flash_attention_sm90.cu", "RT_FLASH_SM90_TILES")
    assert len(compiled) == len(set(compiled))
    assert set(compiled) == {(d, qt, kt) for d, tiles in SM90_TILES.items()
                             for qt, kt in tiles}
    assert "RT_FLASH_SM90_TILES(RT_FLASH_SM90)" in src
    assert "rt_flash_attention_bf16_d##D##_q##QT##_k##KT" in src
    # the f32 tensor-core (3xTF32) kernel's table is the wrapper's too
    tf32x3 = (build.CSRC / "flash_attention_tf32x3.cu").read_text()
    compiled = _compiled_tiles("flash_attention_tf32x3.cu",
                               "RT_FLASH_TF32X3_TILES")
    assert len(compiled) == len(set(compiled))
    assert set(compiled) == {(d, qt, kt) for d, tiles in TF32X3_TILES.items()
                             for qt, kt in tiles}
    assert "RT_FLASH_TF32X3_TILES(RT_FLASH_TF32X3)" in tf32x3
    assert "rt_flash_attention_tf32x3_d##D##_q##QT##_k##KT" in tf32x3
    # and the D = 256 3xTF32 kernel's, under the same launcher names
    d256 = (build.CSRC / "flash_attention_tf32x3_d256.cu").read_text()
    compiled = _compiled_tiles("flash_attention_tf32x3_d256.cu",
                               "RT_FLASH_TF32X3_D256_TILES")
    assert len(compiled) == len(set(compiled))
    assert set(compiled) == {(d, qt, kt)
                             for d, tiles in TF32X3_D256_TILES.items()
                             for qt, kt in tiles}
    assert "RT_FLASH_TF32X3_D256_TILES(RT_FLASH_TF32X3_D256)" in d256
    assert "rt_flash_attention_tf32x3_d##D##_q##QT##_k##KT" in d256
    assert not set(TF32X3_TILES) & set(TF32X3_D256_TILES)
    # every head dim of the f32 CUDA-core kernel has a bf16 kernel too, and
    # every 3xTF32 head dim a CUDA-core one (its replaced design, timed)
    f32 = (build.CSRC / "flash_attention.cu").read_text()
    f32_table = f32[f32.index("#define RT_FLASH_TILES(X)"):]
    f32_table = f32_table[:f32_table.index("\n\n")]
    f32_dims = {int(d) for d in re.findall(r"X\((\d+),", f32_table)}
    assert f32_dims == set(SM90_TILES)
    assert set(TF32X3_TILES) | set(TF32X3_D256_TILES) == f32_dims
    assert "RT_FLASH_TILES(RT_FLASH_F32)" in f32 and "BF16" not in f32


@pytest.mark.parametrize("d", sorted(TF32X3_TILES)
                         + sorted(TF32X3_D256_TILES))
def test_quick_space_runs_every_tf32x3_tile(d):
    """The model-step space's blocks reach every compiled 3xTF32 tile of
    the head dim (D = 256: of its own kernel), as chip_smoke.py requires
    of the card run."""
    from repro_torch.bench.common import model_step_space
    pairs = {(c["flash_block_q"], c["flash_block_k"])
             for c in model_step_space(True).configs()}
    tiles = ROUTE_TILES[route(torch.float32, d)][d]
    assert {physical_tile(bq, bk, tiles) for bq, bk in pairs} == set(tiles)


def test_route_rule_by_dtype_and_head_dim():
    """bf16 takes the tensor-core kernel at every head dim; f32 the 3xTF32
    one up to D = 128 and its D = 256 kernel at 256; no other dtype has a
    kernel, and no route is left to the CUDA cores. Decided without a
    card."""
    assert sorted(TF32X3_TILES) == [16, 32, 64, 80, 128]
    assert sorted(TF32X3_D256_TILES) == [256]
    for d in (16, 32, 64, 80, 128, 256):
        assert route(torch.bfloat16, d) == "tensor_cores"
        assert route(torch.float32, d) == \
            ("tf32x3_d256" if d == 256 else "tf32x3")
    assert route(torch.float32, 48) == "tf32x3"  # raises at launch
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        route(torch.float16, 64)
    assert set(flash_attention.route_launches) == {"tensor_cores", "tf32x3",
                                                   "tf32x3_d256"}
    assert set(ROUTE_TILES) == set(flash_attention.route_launches)


def test_cpu_calls_count_no_route():
    (tq, tk, tv), _ = _both(_qkv(5, 1, 4, 2, 64, 32), torch.bfloat16)
    reset_launch_counts()
    flash_attention(tq, tk, tv, bq=64, bk=64)
    flash_attention(tq.float(), tk.float(), tv.float(), bq=64, bk=64)
    assert flash_attention.route_launches == {"tensor_cores": 0,
                                              "tf32x3": 0, "tf32x3_d256": 0}


def _probe_variants():
    from repro_torch.bench.flash_probe import EDITS
    return sorted(EDITS)


@pytest.mark.parametrize("variant", _probe_variants())
def test_flash_probe_edits_still_match_the_kernel_source(variant):
    """Each variant of ``bench/flash_probe.py`` is an edit of
    ``csrc/flash_attention_tf32x3.cu`` that must still find its text, or
    the probe would measure the shipped kernel under another name; every
    variant builds head dim 64 only."""
    from repro_torch.bench.flash_probe import EDITS, variant_source
    shipped = variant_source("shipped")
    edited = variant_source(variant)
    assert "X(64, 64, 64) X(64, 128, 64)\n\n" in edited
    assert "X(16, 64, 64)" not in edited
    assert (edited != shipped) == (variant != "shipped")
    for old, new in EDITS[variant]:
        assert old not in edited and (not new or new in edited)


def _probe_d256_variants():
    from repro_torch.bench.flash_probe import EDITS_D256
    return sorted(EDITS_D256)


@pytest.mark.parametrize("variant", _probe_d256_variants())
def test_flash_probe_d256_edits_still_match_the_kernel_source(variant):
    """Each ``--head-dim 256`` variant of ``bench/flash_probe.py`` is an
    edit of ``csrc/flash_attention_tf32x3_d256.cu`` that must still find
    its text; every variant builds both designs' tiles, the shipped one
    among them."""
    from repro_torch.bench.flash_probe import (EDITS_D256, TILES_D256,
                                               variant_source)
    shipped = variant_source("shipped", 256)
    edited = variant_source(variant, 256)
    assert ("X(256, 64, 32) X(256, 128, 16)\n\n" in edited
            and set(TILES_D256) == {(64, 32), (128, 16)})
    assert set(TF32X3_D256_TILES[256]) <= set(TILES_D256)
    assert (edited != shipped) == (variant != "shipped")
    for old, new in EDITS_D256[variant]:
        assert old not in edited and (not new or new in edited)
