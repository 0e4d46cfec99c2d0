"""The port's MoE layer against the JAX package's: ``capacity``, the
routing (``gate_idx`` exactly), ``apply_moe`` with and without drops,
``aux_load_balance_loss``, and ``tests/test_moe.py``'s six invariants,
each checked on the port and against the reference on the same weights
(the JAX package's ``materialize``, carried across with ``from_numpy``)
and the same numpy inputs.

Everything here is float32. Tolerance: rtol = atol = 1e-5 (the two
frameworks' einsums summed in different orders; the dispatch and
combine weights themselves are exact). The expert choice is compared
exactly before any output: a flip would move an output by O(1), so it
is reported with the smallest gap between a token's k-th and (k+1)-th
router logit, never tolerated."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.configs as jax_configs
from repro.models import moe as jax_moe
from repro.models import params as jax_params_lib
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch import configs
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
MOE_ARCHS = ["granite_moe_1b_a400m", "mixtral_8x22b"]


def moe_cfg(cls=ModelConfig, E=4, k=2, cap=1.25, group=16):
    """tests/test_moe.py's layer config, in either package."""
    return cls(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
               n_kv_heads=4, d_ff=16, vocab_size=64, n_experts=E, top_k=k,
               capacity_factor=cap, moe_group_size=group, dtype="float32")


def _params(ref_cfg, seed=0):
    """One layer's expert weights from the JAX package: (numpy, port)."""
    p = jax.tree.map(np.asarray, jax_params_lib.materialize(
        jax.random.PRNGKey(seed), jax_moe.moe_defs(ref_cfg)))
    return p, from_numpy(p, device="cpu")


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _check_routing(p_np, p, x, ref_cfg, cfg) -> float:
    """The port's top-k experts of every token equal the reference's
    (its values within TOL); returns the smallest k-th / (k+1)-th gap."""
    G, Sg, _ = moe.group_shape(cfg, *x.shape[:2])
    xg = x.reshape(G, Sg, -1)
    logits = jnp.einsum("gsd,de->gse", jnp.asarray(xg),
                        jnp.asarray(p_np["router"]))
    want_vals, want_idx = jax.lax.top_k(logits, ref_cfg.top_k)
    vals, idx = moe.route(p, torch.from_numpy(xg), cfg)
    ranked = np.sort(np.asarray(logits), axis=-1)[..., ::-1]
    gap = (np.inf if cfg.top_k == cfg.n_experts else
           float((ranked[..., cfg.top_k - 1] - ranked[..., cfg.top_k]).min()))
    assert np.array_equal(idx.numpy(), np.asarray(want_idx)), \
        f"expert choice differs (smallest top-k gap {gap:.3e})"
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals), **TOL)
    return gap


def _both(p_np, p, x, ref_cfg, cfg, drop=True):
    want = np.asarray(jax_moe.apply_moe(jax.tree.map(jnp.asarray, p_np),
                                        jnp.asarray(x), ref_cfg, drop=drop))
    got = moe.apply_moe(p, torch.from_numpy(x), cfg, drop=drop).numpy()
    return got, want


# ---------------------------------------------------------------------------
# tests/test_moe.py's six, on the port and against the reference
# ---------------------------------------------------------------------------


def test_capacity_formula():
    cfg = moe_cfg(E=8, k=2, cap=1.0)
    assert moe.capacity(cfg, 64) == 16          # 64 tokens * 2 / 8
    assert moe.capacity(cfg, 4) == 8            # the floor of 8
    ref = moe_cfg(JaxModelConfig, E=8, k=2, cap=1.0)
    assert [moe.capacity(cfg, n) for n in (4, 64)] == \
        [jax_moe.capacity(ref, n) for n in (4, 64)]


def test_moe_forward_shapes_finite():
    ref_cfg, cfg = moe_cfg(JaxModelConfig), moe_cfg()
    p_np, p = _params(ref_cfg)
    x = _x(1, 2, 16, cfg.d_model)
    _check_routing(p_np, p, x, ref_cfg, cfg)
    got, want = _both(p_np, p, x, ref_cfg, cfg)
    assert got.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_dropped_tokens_fall_through_residual():
    """With capacity factor ~0 the floor of 8 slots an expert holds; of
    1024 tokens on 2 experts almost all are dropped, and a dropped
    token's output is exactly zero (the residual carries it), the same
    rows as the reference's."""
    assert moe.capacity(moe_cfg(cap=1e-9), 16) == 8
    ref_cfg = moe_cfg(JaxModelConfig, E=2, k=1, cap=1e-9, group=1024)
    cfg = moe_cfg(E=2, k=1, cap=1e-9, group=1024)
    p_np, p = _params(ref_cfg)
    x = _x(1, 1, 1024, cfg.d_model)
    _check_routing(p_np, p, x, ref_cfg, cfg)
    got, want = _both(p_np, p, x, ref_cfg, cfg)
    zero = np.all(got == 0.0, axis=-1)
    assert zero.mean() > 0.9
    assert np.array_equal(zero, np.all(want == 0.0, axis=-1))
    assert zero.size - zero.sum() == 16          # 2 experts x 8 slots
    np.testing.assert_allclose(got, want, **TOL)


def test_top1_equivalence_to_dense_expert():
    """E=1, k=1, ample capacity: the layer is that expert's FFN (the gate
    softmax of one value is 1)."""
    ref_cfg, cfg = (moe_cfg(JaxModelConfig, E=1, k=1, cap=2.0),
                    moe_cfg(E=1, k=1, cap=2.0))
    p_np, p = _params(ref_cfg)
    x = torch.from_numpy(_x(1, 1, 8, cfg.d_model))
    y = moe.apply_moe(p, x, cfg)
    w_g, w_u, w_d = p["w_gate"][0], p["w_up"][0], p["w_down"][0]
    dense = (F.silu(x @ w_g) * (x @ w_u)) @ w_d
    np.testing.assert_allclose(y.numpy(), dense.numpy(), rtol=1e-4,
                               atol=1e-4)
    got, want = _both(p_np, p, x.numpy(), ref_cfg, cfg)
    np.testing.assert_allclose(got, want, **TOL)


def test_aux_loss_positive_and_balanced_bound():
    ref_cfg, cfg = moe_cfg(JaxModelConfig, E=4, k=1), moe_cfg(E=4, k=1)
    p_np, p = _params(ref_cfg)
    x = _x(2, 2, 64, cfg.d_model)
    aux = float(moe.aux_load_balance_loss(p, torch.from_numpy(x), cfg))
    assert aux >= 0.99         # 1.0 perfectly balanced, >= 1 otherwise
    want = float(jax_moe.aux_load_balance_loss(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x), ref_cfg))
    assert abs(aux / want - 1.0) < 1e-5


def test_gate_weights_sum_to_one():
    """Without drops a token's combine weights are the softmax of its
    top-k logits: they sum to one, and the layer is the gate-weighted
    sum of its experts' FFNs."""
    ref_cfg, cfg = (moe_cfg(JaxModelConfig, E=4, k=2, cap=4.0),
                    moe_cfg(E=4, k=2, cap=4.0))
    p_np, p = _params(ref_cfg)
    x = torch.from_numpy(_x(3, 1, 16, cfg.d_model))
    _check_routing(p_np, p, x.numpy(), ref_cfg, cfg)
    vals, idx = moe.route(p, x, cfg)
    probs = torch.softmax(vals, dim=-1)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-6)
    experts = torch.stack([
        (F.silu(x[0] @ p["w_gate"][e]) * (x[0] @ p["w_up"][e]))
        @ p["w_down"][e] for e in range(cfg.n_experts)])   # (E, S, D)
    mixed = sum(probs[0, :, j, None] * experts[idx[0, :, j],
                                               torch.arange(16)]
                for j in range(cfg.top_k))
    y = moe.apply_moe(p, x, cfg)
    np.testing.assert_allclose(y[0].numpy(), mixed.numpy(), rtol=1e-4,
                               atol=1e-5)
    got, want = _both(p_np, p, x.numpy(), ref_cfg, cfg)
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# apply_moe, aux loss and capacity against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("b,s", [(2, 32), (2, 12), (3, 1)],
                         ids=["groups", "one-group-a-row", "decode"])
def test_apply_moe_matches_the_reference(arch, drop, b, s):
    """SMOKE widths: several groups a row, an odd length (one group a
    row), and decode's S = 1 (a group a token); with drops (training)
    and drop-free (prefill, decode)."""
    ref_cfg, cfg = jax_configs.get_smoke(arch), configs.get_smoke(arch)
    p_np, p = _params(ref_cfg, seed=4)
    x = _x(5, b, s, cfg.d_model)
    gap = _check_routing(p_np, p, x, ref_cfg, cfg)
    got, want = _both(p_np, p, x, ref_cfg, cfg, drop=drop)
    print(f"{arch} B={b} S={s} drop={drop}: smallest top-k gap {gap:.3e}")
    np.testing.assert_allclose(got, want, **TOL)


def test_drop_free_routing_keeps_every_token_and_drops_change_the_result():
    """Drop-free, a token's output does not depend on the tokens sharing
    its group (so prefill and decode agree); with drops, tokens over
    capacity fall through and the outputs differ."""
    cfg = dataclasses.replace(configs.get_smoke("granite_moe_1b_a400m"),
                              capacity_factor=0.5)
    ref_cfg = dataclasses.replace(
        jax_configs.get_smoke("granite_moe_1b_a400m"), capacity_factor=0.5)
    p_np, p = _params(ref_cfg, seed=6)
    x = _x(7, 2, 32, cfg.d_model)
    whole = moe.apply_moe(p, torch.from_numpy(x), cfg, drop=False)
    one_by_one = torch.cat([
        moe.apply_moe(p, torch.from_numpy(x[:, t:t + 1]), cfg, drop=False)
        for t in range(32)], dim=1)
    np.testing.assert_allclose(whole.numpy(), one_by_one.numpy(), **TOL)
    dropped = moe.apply_moe(p, torch.from_numpy(x), cfg, drop=True)
    assert not torch.allclose(dropped, whole)
    got, want = _both(p_np, p, x, ref_cfg, cfg, drop=True)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_load_balance_loss_matches_the_reference(arch):
    ref_cfg, cfg = jax_configs.get_smoke(arch), configs.get_smoke(arch)
    p_np, p = _params(ref_cfg, seed=8)
    x = _x(9, 2, 24, cfg.d_model)
    got = float(moe.aux_load_balance_loss(p, torch.from_numpy(x), cfg))
    want = float(jax_moe.aux_load_balance_loss(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x), ref_cfg))
    assert abs(got / want - 1.0) < 1e-5


@pytest.mark.parametrize("E,k,cap", [(8, 2, 1.0), (4, 2, 1.25), (32, 8, 1.25),
                                     (8, 2, 1.3), (3, 1, 0.7), (2, 1, 1e-9)])
def test_capacity_matches_the_reference_over_a_grid(E, k, cap):
    """Group sizes from 1 to 4096 across the floor of 8 and the rounding
    to a multiple of 8 (truncation first: 3 experts and factor 0.7 give
    fractional shares), and every config's own group size."""
    cfg, ref = (moe_cfg(E=E, k=k, cap=cap),
                moe_cfg(JaxModelConfig, E=E, k=k, cap=cap))
    sizes = list(range(1, 97)) + [255, 256, 257, 1000, 1024, 4096]
    got = [moe.capacity(cfg, n) for n in sizes]
    assert got == [jax_moe.capacity(ref, n) for n in sizes]
    assert all(c >= 8 and c % 8 == 0 for c in got)
    assert 8 in got and any(c > 8 for c in got) == (cap > 1e-3)
    for arch in configs.ARCH_IDS:
        for ours, theirs in ((configs.get(arch), jax_configs.get(arch)),
                             (configs.get_smoke(arch),
                              jax_configs.get_smoke(arch))):
            if ours.n_experts:
                n = ours.moe_group_size
                assert moe.capacity(ours, n) == jax_moe.capacity(theirs, n)


def test_granite_moe_full_width_group_shapes():
    """granite-moe at full width: training at B=1, S=4096 routes 16
    groups of 256 tokens into 80 slots an expert; its drop-free prefill
    of 4 x 4096 packs 2048 slots (256 x top-8) in each of 64 groups, and
    decode one token a group into 8."""
    cfg = configs.get("granite_moe_1b_a400m")
    assert moe.group_shape(cfg, 1, 4096) == (16, 256, 80)
    assert moe.group_shape(cfg, 4, 4096, drop=False) == (64, 256, 2048)
    assert moe.group_shape(cfg, 4, 1, drop=False) == (4, 1, 8)
    assert moe.group_shape(cfg, 1, 576, drop=False) == (1, 576, 4608)


@pytest.mark.parametrize("drop", [True, False])
def test_moe_ops_run_in_their_scopes(drop):
    """Every op that ``apply_moe`` dispatches carries its part's scope:
    the router's product, the expert products, and the dispatch and
    combine products each hold their FLOPs; nothing is left open."""
    from repro_torch.analysis import ops
    cfg = moe_cfg()
    p = _params(moe_cfg(JaxModelConfig))[1]
    x = torch.from_numpy(_x(0, 2, 32, cfg.d_model))
    counted = ops.count_ops(moe.apply_moe, (p, x, cfg), {"drop": drop})
    assert not ops._SCOPES
    G, Sg, C = moe.group_shape(cfg, 2, 32, drop)
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    flops, kinds = {}, {}
    for op in counted.ops:
        flops[op.scope] = flops.get(op.scope, 0.0) + op.flops
        kinds.setdefault(op.scope, set()).add(op.kind)
    assert set(flops) == {"moe.router", "moe.slots", "moe.dispatch",
                          "moe.experts", "moe.combine"}
    assert flops["moe.router"] == 2.0 * G * Sg * D * E
    assert flops["moe.experts"] == 3 * 2.0 * G * E * C * D * F_
    assert flops["moe.dispatch"] == flops["moe.combine"] == \
        2.0 * G * Sg * E * C * D
    assert "aten::topk" in kinds["moe.router"]
    assert "aten::cumsum" in kinds["moe.slots"]


def test_attribution_sums_the_moe_scopes():
    """A static attribution of granite-moe's SMOKE train step sums its
    forward's MoE ops per scope, in its JSON and its markdown; a dense
    model's report has neither, as the reference's."""
    import json

    from repro_torch.models.workloads import build_workload
    from repro_torch.obs.attribution import attribute
    moe_cfg_ = configs.get_smoke("granite_moe_1b_a400m")
    rep = attribute(build_workload("train_step", moe_cfg_, device="cpu"))
    scopes = rep.scopes()
    assert list(scopes) == ["moe.router", "moe.slots", "moe.dispatch",
                            "moe.experts", "moe.combine", "moe.aux"]
    for name, s in scopes.items():
        ops_ = [op for op in rep.ops if op.scope == name]
        assert s["ops"] == len(ops_) > 0
        assert s["flops"] == sum(op.flops for op in ops_)
        assert s["bytes"] == sum(op.bytes_accessed for op in ops_)
    assert scopes["moe.experts"]["flops"] > 0
    assert json.loads(json.dumps(rep.to_json()))["scopes"] == scopes
    assert "### Scopes" in rep.to_markdown()
    assert "| moe.experts |" in rep.to_markdown()
    dense = attribute(build_workload("train_step", device="cpu"))
    assert not dense.scopes() and "scopes" not in dense.to_json()
    assert "### Scopes" not in dense.to_markdown()
    assert all("scope" not in op.to_json() for op in dense.ops)
