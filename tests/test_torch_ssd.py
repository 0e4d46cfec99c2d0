"""The port's SSD chunk scan against the JAX package's: the same numpy
inputs through ``ssd_chunk_scan_pallas`` (Pallas in interpret mode, as
``tests/test_kernel_ssd.py`` runs it), ``ssd_chunk_scan_ref`` and the
model-layout ``ops.ssd_chunk_scan``, and through the port's wrapper on
CPU tensors (its plain version, through the autograd function).

Tolerances: outputs at 2e-5 (rtol = atol), the reference tests' bound
for the kernel against its oracle in f32; the final state against a
sequential numpy recurrence at 1e-5 (one f32 recurrence against
another, orders of summation differ); gradients at rtol 1e-4 / atol
1e-5, the summation-order gap of two f32 autograd passes over the same
math."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import flops as jax_flops
from repro.kernels.ssd import ssd_chunk_scan as jax_ops_scan
from repro.kernels.ssd import ssd_chunk_scan_pallas, ssd_chunk_scan_ref as \
    jax_scan_ref
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ssd import (KERNELS, bytes_moved, chunk_scan, flops,
                                     grid, needed_flops, ssd_chunk_scan,
                                     tma_rows, work_items)

TOL = dict(rtol=2e-5, atol=2e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = [dict(), dict(Q=32, P=16, N=8), dict(B=1, H=8, C=2),
          dict(C=8, Q=8)]                       # tests/test_kernel_ssd.py


def make_inputs(B=2, H=3, C=4, Q=16, P=8, N=16, seed=0):
    """The reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    xdt = (rng.standard_normal((B, H, C, Q, P)) * 0.5).astype(np.float32)
    bm = (rng.standard_normal((B, C, Q, N)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((B, C, Q, N)) * 0.5).astype(np.float32)
    a = -rng.uniform(0.01, 0.2, (B, H, C, Q)).astype(np.float32)
    return xdt, bm, cm, np.cumsum(a, axis=-1).astype(np.float32)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _state_by_recurrence(xdt, bm, cum):
    """The state after the last position, one position at a time:
    h <- exp(a_t) h + xdt_t ⊗ b_t, with a_t the step of cum."""
    B, H, C, Q, P = xdt.shape
    N = bm.shape[-1]
    h = np.zeros((B, H, P, N), np.float64)
    for c in range(C):
        prev = np.zeros((B, H))
        for t in range(Q):
            step = cum[:, :, c, t] - prev
            prev = cum[:, :, c, t]
            h = np.exp(step)[..., None, None] * h + \
                xdt[:, :, c, t, :, None] * bm[:, None, c, t, None, :]
    return h


def _three_phases(xdt, bm, cm, cum, h0=None):
    """The chunk-parallel decomposition the CUDA kernel follows, in plain
    torch: (1) each chunk's own state contribution, (2) the sequential
    state carry, (3) the output from the scores and the entering state.
    Returns (y, final state, the state entering each chunk)."""
    B, H, C, Q, P = xdt.shape
    N = bm.shape[-1]
    # 1. s_c = (xdt_c ⊙ exp(cum_c[Q-1] - cum_c))ᵀ B_c, every chunk at once
    w = torch.exp(cum[..., -1:] - cum)                     # (B, H, C, Q)
    s = torch.einsum("bhcqp,bcqn->bhcpn", xdt * w[..., None], bm)
    # 2. the carry: the state entering chunk c, then h <- e^{total} h + s_c
    h = torch.zeros(B, H, P, N) if h0 is None else h0
    entering = []
    for c in range(C):
        entering.append(h)
        h = torch.exp(cum[:, :, c, -1])[..., None, None] * h + s[:, :, c]
    entering = torch.stack(entering, dim=2)                # (B, H, C, P, N)
    # 3. y = (C Bᵀ ⊙ L) xdt + (C hᵀ) ⊙ exp(cum), every chunk at once
    scores = torch.einsum("bcin,bcjn->bcij", cm, bm)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    decay = torch.exp((cum[..., :, None] - cum[..., None, :])
                      .masked_fill(~causal, float("-inf")))
    y = torch.einsum("bcij,bhcij,bhcjp->bhcip", scores, decay, xdt) + \
        torch.einsum("bcin,bhcpn->bhcip", cm, entering) * \
        torch.exp(cum)[..., None]
    return y, h, entering


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_chunk_parallel_phases_match_the_reference(shape):
    """The kernel's three phases give the JAX reference's y, the
    recurrence's final state and, for every chunk, the recurrence's state
    entering it; split into two launches at the middle chunk, the second
    starting from the first's returned state (``h0``, ``return_state``),
    they give the same y and final state."""
    arrays = make_inputs(**shape)
    xdt, bm, cm, cum = arrays
    want = np.asarray(jax_scan_ref(*map(jnp.asarray, arrays)))
    y, h_final, entering = _three_phases(*_t(arrays))
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    np.testing.assert_allclose(h_final.numpy(),
                               _state_by_recurrence(xdt, bm, cum),
                               **STATE_TOL)
    for c in range(xdt.shape[2]):
        np.testing.assert_allclose(
            entering[:, :, c].numpy(),
            _state_by_recurrence(xdt[:, :, :c], bm[:, :c], cum[:, :, :c]),
            err_msg=f"state entering chunk {c}", **STATE_TOL)
    k = xdt.shape[2] // 2
    y0, h_mid, _ = _three_phases(*_t((xdt[:, :, :k], bm[:, :k], cm[:, :k],
                                      cum[:, :, :k])))
    y1, h_end, _ = _three_phases(*_t((xdt[:, :, k:], bm[:, k:], cm[:, k:],
                                      cum[:, :, k:])), h0=h_mid)
    np.testing.assert_allclose(torch.cat([y0, y1], dim=2).numpy(), want,
                               **TOL)
    np.testing.assert_allclose(h_end.numpy(), h_final.numpy(), **STATE_TOL)


def test_grid_flattens_the_chunks_and_puts_the_heads_on_x():
    """The four kernels' blocks at the main path's shapes and at a shape
    with B·H·C over 65,535: the three tensor-core kernels are persistent
    (at most one block an SM walking their work items, heads in pairs, one
    a consumer warpgroup), the state carry flat on x."""
    assert work_items(4, 24, 128, 256, 64, 128) == {
        "ssd_scores_kernel": 4 * 128 * 4 * 2,
        "ssd_states_kernel": 4 * 128 * 12 * 1 * 2,
        "ssd_output_kernel": 2 * 4 * 128 * 12 * 1}
    assert grid(4, 24, 128, 256, 64, 128) == {
        "ssd_scores_kernel": (132, 1), "ssd_states_kernel": (132, 1),
        "ssd_pass_kernel": (8 * 4 * 24, 1),
        "ssd_output_kernel": (132, 1)}
    assert work_items(1, 80, 32, 128, 64, 64) == {
        "ssd_scores_kernel": 32 * 2 * 1, "ssd_states_kernel": 32 * 40,
        "ssd_output_kernel": 32 * 40}
    assert grid(1, 80, 32, 128, 64, 64, sms=4096) == {
        "ssd_scores_kernel": (64, 1), "ssd_states_kernel": (1280, 1),
        "ssd_pass_kernel": (4 * 80, 1), "ssd_output_kernel": (1280, 1)}
    big = grid(1, 9, 8192, 8, 8, 16)
    assert big["ssd_states_kernel"] == big["ssd_output_kernel"] == (132, 1)
    assert work_items(1, 9, 8192, 8, 8, 16)["ssd_output_kernel"] == \
        8192 * 5
    # N not a multiple of 4: one state element a thread
    assert grid(1, 3, 2, 130, 33, 5)["ssd_pass_kernel"] == (3, 1)
    assert grid(1, 3, 2, 130, 34, 6)["ssd_pass_kernel"] == (3, 1)
    assert grid(1, 1, 1, 1, 65, 200)["ssd_states_kernel"] == (8, 1)
    assert work_items(1, 1, 1, 1, 65, 200)["ssd_states_kernel"] == 2 * 4


def test_a_grid_past_cudas_limits_raises_before_the_library():
    """B·H·C = 2**31 chunks pass the tensor maps' 32-bit chunk coordinate
    (TMA's coordinates are signed 32-bit): refused before the library."""
    from repro_torch.kernels.ssd import ops
    b, h, c = 1, 65536, 32768                  # B·H·C = 2**31
    meta = [torch.empty(shape, device="meta") for shape in
            ((b, h, c, 1, 1), (b, c, 1, 1), (b, c, 1, 1), (b, h, c, 1))]
    with pytest.raises(ValueError, match="ssd_states_kernel"):
        ops._launch(*meta, None, False)


def test_a_misaligned_h0_gives_the_one_element_state_carry_grid(
        monkeypatch):
    """The state carry reads ``h0`` 4 elements a thread only from a
    16-byte boundary (``csrc/ssd.cu``), so the limit check must count the
    4x larger state-carry grid of a misaligned ``h0``; the persistent
    kernels' grids do not change."""
    from repro_torch.kernels.ssd import ops
    b, h, c, q, p, n = 1, 2, 1, 1, 64, 64
    storage = torch.zeros(b * h * p * n + 1)
    aligned = storage[:-1].view(b, h, p, n)
    shifted = storage[1:].view(b, h, p, n)      # 4 bytes off the boundary
    assert ops.h0_aligned(None) and ops.h0_aligned(aligned)
    assert not ops.h0_aligned(shifted)
    assert grid(b, h, c, q, p, n)["ssd_pass_kernel"] == (8, 1)
    assert grid(b, h, c, q, p, n, ops.h0_aligned(shifted)) == {
        **grid(b, h, c, q, p, n), "ssd_pass_kernel": (32, 1)}
    # a grid limit the aligned launch meets rejects the misaligned one
    # before the library is touched
    monkeypatch.setattr(ops, "_MAX_GRID_X", 8)
    ins = [torch.zeros(shape) for shape in
           ((b, h, c, q, p), (b, c, q, n), (b, c, q, n), (b, h, c, q))]
    with pytest.raises(ValueError, match=r"\(32, 1\) blocks for "
                                         r"ssd_pass_kernel"):
        ops._launch(*ins, shifted, False)


def test_kernel_names_are_the_sources_kernels():
    """``KERNELS`` (the names a trace looks up) are the ``__global__``
    functions of ``csrc/ssd.cu``, in launch order."""
    import re

    from repro_torch.kernels import build
    src = (build.CSRC / "ssd.cu").read_text(encoding="utf-8")
    defined = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\n"
                         r"(\w+)\(", src)
    # launched directly (<<<), or through a pointer to one of two
    # instantiations (the first of them: ``ssd_..._kernel<...> :``)
    launched = re.findall(r"\b(ssd_\w+_kernel)\b(?:<[^>]*>)?(?:<<<| :)",
                          src)
    assert tuple(defined) == KERNELS
    assert launched == list(KERNELS)


@pytest.mark.parametrize("shape,cols,ld,copied", [
    ((2, 3, 4, 16, 8), 8, 8, False),       # 32-byte rows: taken as they are
    ((2, 3, 4, 16, 6), 6, 8, True),        # P = 6: 24-byte rows
    ((1, 3, 2, 10), 10, 12, True),         # N = 10
    ((1, 3, 2, 50), 50, 52, True),         # Q = 50 (cum)
    ((4, 24, 128, 256), 256, 256, False)], ids=str)
def test_rows_not_16_bytes_apart_take_a_rounded_up_copy(shape, cols, ld,
                                                         copied):
    """TMA wants rows a multiple of 16 bytes apart: rows of 4k floats are
    handed over as they are, others go through a buffer whose rows are
    rounded up to 4 floats, with the tensor's values in the first
    columns."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32))
    got, got_ld = tma_rows(x)
    assert got_ld == ld and got.shape == (*shape[:-1], ld)
    assert (got.data_ptr() != x.data_ptr()) == copied
    assert torch.equal(got[..., :cols], x)


def test_a_view_off_the_16_byte_boundary_is_copied():
    storage = torch.arange(1 + 2 * 3 * 8, dtype=torch.float32)
    view = storage[1:].view(2, 3, 8)           # rows of 8 floats, 4 bytes off
    got, ld = tma_rows(view)
    assert ld == 8 and got.data_ptr() % 16 == 0
    assert got.data_ptr() != view.data_ptr() and torch.equal(got, view)


def test_launch_hands_the_kernel_tma_ready_rows_and_padded_scratch(
        monkeypatch):
    """``_launch`` passes the launcher each operand with its row stride
    (rounded-up copies where a row is not 16 bytes), the scores scratch
    (B, C, Q, ld_q) and the states scratch (B, H, C, P, ld_n); y and the
    final state dense. A fake launcher records the call."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ops
    calls = []

    def fake(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(ops, "_LAUNCHER", [fake])
    monkeypatch.setattr(build, "current_stream_ptr", lambda index: 0)
    b, h, c, q, p, n = 1, 3, 2, 50, 6, 10
    xdt, bm, cm, cum = _t(make_inputs(B=b, H=h, C=c, Q=q, P=p, N=n))
    before = ssd_chunk_scan.launches
    y, h_out = ops._launch(xdt, bm, cm, cum, None, True)
    assert ssd_chunk_scan.launches == before + 1
    (args,) = calls
    assert args[9:18] == (b, h, c, q, p, n, 8, 12, 52)
    assert args[4] is None and y.shape == (b, h, c, q, p)
    assert h_out.shape == (b, h, p, n)
    for ptr in args[:4] + args[7:9]:
        assert ptr % 16 == 0


@pytest.mark.parametrize("variant", ["tensor_core_sums", "no_split",
                                     "no_loads", "one_product",
                                     "partials_k64"])
def test_probe_edits_still_match_the_kernel_source(variant):
    """Each variant of ``bench/ssd_probe.py`` is an edit of ``csrc/ssd.cu``
    that must find its text exactly once, or the probe would measure the
    shipped kernel under another name."""
    from repro_torch.bench.ssd_probe import EDITS, variant_source
    shipped = variant_source("shipped")
    edited = variant_source(variant)
    assert edited != shipped
    for old, new in EDITS[variant]:
        assert new in edited


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_version_matches_the_pallas_kernel_and_its_oracle(shape):
    arrays = make_inputs(**shape)
    got, h_final = chunk_scan(*_t(arrays), return_state=True)
    jarrays = [jnp.asarray(a) for a in arrays]
    for want in (ssd_chunk_scan_pallas(*jarrays, interpret=True),
                 jax_scan_ref(*jarrays)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(h_final.numpy(),
                               _state_by_recurrence(arrays[0], arrays[1],
                                                    arrays[3]), **STATE_TOL)


def test_state_carries_across_chunks():
    xdt, bm, cm, cum = make_inputs(B=1, H=1, C=3, Q=8, P=4, N=4)
    out = chunk_scan(*_t((xdt, bm, cm, cum)))
    xdt0 = xdt.copy()
    xdt0[:, :, 0] = 0.0
    out0 = chunk_scan(*_t((xdt0, bm, cm, cum)))
    assert float((out[:, :, 1:] - out0[:, :, 1:]).abs().max()) > 1e-6
    # an initial state enters every chunk's output like a carried one
    h0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 1, 4, 4)).astype(np.float32))
    y, h = chunk_scan(*_t((xdt, bm, cm, cum)), h0=h0, return_state=True)
    y_split, h_mid = chunk_scan(*_t((xdt[:, :, :1], bm[:, :1], cm[:, :1],
                                      cum[:, :, :1])), h0=h0,
                                return_state=True)
    y_rest, h_end = chunk_scan(*_t((xdt[:, :, 1:], bm[:, 1:], cm[:, 1:],
                                     cum[:, :, 1:])), h0=h_mid,
                               return_state=True)
    torch.testing.assert_close(y, torch.cat([y_split, y_rest], dim=2))
    torch.testing.assert_close(h, h_end)


@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 16), (16, 64)])
def test_model_layout_wrapper_matches_the_reference_ops(S, chunk):
    rng = np.random.default_rng(S + chunk)
    B, H, P, N = 2, 4, 8, 16
    x = rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.5
    dt = rng.uniform(0.05, 0.5, (B, S, H)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    bm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.5
    cm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.5
    want = jax_ops_scan(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk=chunk,
                        interpret=True)
    got = ssd_chunk_scan(*_t((x, dt, a, bm, cm)), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="divide"):
        ssd_chunk_scan(*_t((x, dt, a, bm, cm)), chunk=S // 2 + 1)


@pytest.mark.parametrize("args", [(2, 3, 64, 16, 8, 16),
                                  (4, 24, 32768, 256, 64, 128),
                                  (1, 80, 4096, 128, 64, 64)], ids=str)
def test_flops_equal_the_reference(args):
    assert flops(*args) == jax_flops(*args)


@pytest.mark.parametrize("args", [(2, 3, 64, 16, 8, 16),
                                  (4, 24, 32768, 256, 64, 128),
                                  (1, 80, 4096, 128, 64, 64)], ids=str)
def test_needed_flops_count_shared_scores_once_and_the_causal_triangle(
        args):
    B, H, S, Q, P, N = args
    causal = int(torch.ones(Q, Q).tril().sum())        # entries with i >= j
    per_chunk = 2 * causal * N + H * (2 * causal * P + 2 * 2 * Q * P * N)
    assert needed_flops(*args) == B * (S // Q) * per_chunk < flops(*args)
    # one head and one-position chunks: nothing shared, nothing masked
    assert needed_flops(B, 1, S, 1, P, N) == jax_flops(B, 1, S, 1, P, N)


def test_bytes_moved_counts_each_operand_once():
    xdt, bm, cm, cum = _t(make_inputs())
    words = 2 * xdt.numel() + 2 * bm.numel() + cum.numel()
    assert bytes_moved(2, 3, 64, 16, 8, 16) == 4.0 * words
    assert bytes_moved(2, 3, 64, 16, 8, 16, True) == \
        4.0 * (words + 2 * 3 * 8 * 16)


def test_gradients_match_jax_grad_of_the_reference():
    arrays = make_inputs(B=1, H=2, C=3, Q=8, P=4, N=8, seed=3)
    g = np.random.default_rng(4).standard_normal(
        arrays[0].shape).astype(np.float32)

    def jax_loss(*xs):
        return jnp.sum(jax_scan_ref(*xs) * g)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a) for a in arrays])
    leaves = [t.requires_grad_() for t in _t(arrays)]
    got = torch.autograd.grad((chunk_scan(*leaves) * torch.from_numpy(g))
                              .sum(), leaves)
    for name, x, y in zip(("xdt", "bm", "cm", "cum"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), err_msg=name,
                                   **GRAD_TOL)


def test_gradients_stay_finite_past_the_exp_range():
    """A chunk whose cumsum spans more than ~88 overflows exp above the
    diagonal; the reference's where-after-exp then gives NaN gradients,
    the port's masked exponent does not, and both agree on the values."""
    xdt, bm, cm, _ = make_inputs(B=1, H=1, C=2, Q=64, P=4, N=4, seed=5)
    cum = np.cumsum(np.full((1, 1, 2, 64), -2.0, np.float32), axis=-1)
    jgrad = jax.grad(lambda c: jnp.sum(jax_scan_ref(
        jnp.asarray(xdt), jnp.asarray(bm), jnp.asarray(cm), c)))(
        jnp.asarray(cum))
    assert np.isnan(np.asarray(jgrad)).any()
    leaf = torch.from_numpy(cum).requires_grad_()
    y = chunk_scan(*_t((xdt, bm, cm)), leaf)
    (grad,) = torch.autograd.grad(y.sum(), [leaf])
    assert torch.isfinite(grad).all()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jax_scan_ref(
        *map(jnp.asarray, (xdt, bm, cm, cum)))), **TOL)


def test_cpu_and_meta_tensors_launch_nothing():
    reset_launch_counts()
    arrays = _t(make_inputs())
    chunk_scan(*arrays)
    ssd_chunk_scan.resolve(arrays, chunk=8)(
        torch.ones(1, 16, 2, 4), torch.ones(1, 16, 2), -torch.ones(2),
        torch.ones(1, 16, 4), torch.ones(1, 16, 4))
    meta = [torch.empty(a.shape, device="meta") for a in arrays]
    y, h = chunk_scan(*meta, return_state=True)
    assert y.device.type == "meta" and y.shape == arrays[0].shape
    assert h.shape == (2, 3, 8, 16)
    assert launch_counts()["ssd_chunk_scan"] == 0


def test_shape_errors_raise():
    xdt, bm, cm, cum = _t(make_inputs())
    with pytest.raises(ValueError, match="B/C"):
        chunk_scan(xdt, bm[:, :2], cm, cum)
    with pytest.raises(ValueError, match="cum"):
        chunk_scan(xdt, bm, cm, cum[:, :2])
    with pytest.raises(ValueError, match="h0"):
        chunk_scan(xdt, bm, cm, cum, h0=torch.zeros(2, 3, 8, 8))


def test_card_path_launches_or_raises(monkeypatch, tmp_path):
    """Without a card ``cuda`` operands cannot be made, the entry points
    refuse the default device, and the launch path needs the kernel
    library (nvcc), with no plain fallback."""
    import shutil

    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ops
    from repro_torch.models.workloads import build_workload
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        build_workload("prefill_step", "mamba2_130m")
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(ops, "_LAUNCHER", [])
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops._launch(*_t(make_inputs()), None, False)
    assert launch_counts()["ssd_chunk_scan"] == 0
