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
from repro_torch.kernels.ssd import (bytes_moved, chunk_scan, flops,
                                     needed_flops, ssd_chunk_scan)

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
