"""The port's optimizer against the JAX package's: AdamW's convergence,
clipping and state layout, the cosine and WSD schedules (the reference's
``tests/test_optim.py``), and the same AdamW steps and schedules on the
same inputs in both packages.

Tolerances: rtol 1e-6 (atol 0) for the schedules at every step and the
global norm; for five AdamW steps on identical gradients (parameters,
both moments), in float32 and bfloat16 leaves, rtol 1e-6 of each element,
with the clip active and not. Both packages round each product and sum
where the other does (the reference runs op by op here, unjitted), but
XLA and torch sum a tensor's squares in different orders, so the global
norm may differ by an ulp. Unclipped, the scale is exactly 1 and atol
is 0. With an active clip the scale may differ by an ulp too; where
``b1 * m`` and ``(1 - b1) * g`` nearly cancel, that ulp is a larger
share of the element (2e-6 of one element of 72 here), so the clipped
case adds atol 1e-6 of the leaf's largest magnitude. A bfloat16 leaf
agrees bit for bit unless a float32 ulp moves it across a rounding
boundary."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.optim as jax_optim
from repro.models.params import ParamDef as JaxParamDef
from repro_torch.models.params import ParamDef, materialize
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm, make_schedule,
                               opt_state_defs, wsd_schedule)

RTOL = dict(rtol=1e-6, atol=0.0)


def quad_defs():
    return {"w": ParamDef(shape=(8,), logical=(None,), dtype=torch.float32)}


def test_adamw_converges_on_quadratic():
    defs = quad_defs()
    params = materialize(torch.Generator().manual_seed(0), defs)
    opt = adamw_init(defs, "cpu")
    target = torch.arange(8.0)

    def loss(p):
        return torch.sum(torch.square(p["w"] - target))

    cfg = AdamWConfig(weight_decay=0.0)
    l0 = float(loss(params))
    for _ in range(300):
        g = {"w": 2.0 * (params["w"] - target)}
        params, opt, _ = adamw_update(params, g, opt, 0.05, cfg)
    assert float(loss(params)) < 0.01 * l0


def test_grad_clipping_bounds_update():
    defs = quad_defs()
    params = materialize(torch.Generator().manual_seed(0), defs)
    before = params["w"].clone()
    opt = adamw_init(defs, "cpu")
    huge = {"w": torch.full((8,), 1e9)}
    cfg = AdamWConfig(clip_norm=1.0, weight_decay=0.0)
    new_params, _, metrics = adamw_update(params, huge, opt, 0.1, cfg)
    assert float(metrics["grad_norm"]) > 1e8       # reported pre-clip
    delta = float(torch.max(torch.abs(new_params["w"] - before)))
    assert delta < 1.0                              # clipped step is bounded


def test_opt_state_layout_matches_params():
    defs = quad_defs()
    od = opt_state_defs(defs)
    assert od["m"]["w"].logical == defs["w"].logical
    assert od["v"]["w"].shape == defs["w"].shape
    assert od["m"]["w"].dtype == torch.float32
    assert od["count"].shape == () and od["count"].dtype == torch.float32
    ref = jax_optim.opt_state_defs(
        {"w": JaxParamDef(shape=(8,), logical=(None,), dtype=jnp.bfloat16)})
    assert (od["m"]["w"].shape, od["m"]["w"].logical, od["m"]["w"].init) == \
        (ref["m"]["w"].shape, ref["m"]["w"].logical, ref["m"]["w"].init)


def test_adamw_init_is_zeros_on_the_device():
    state = adamw_init({"a": {"b": ParamDef((2, 3), (None, None))}}, "cpu")
    assert state["m"]["a"]["b"].dtype == torch.float32
    assert state["m"]["a"]["b"].shape == (2, 3)
    assert not state["v"]["a"]["b"].any() and float(state["count"]) == 0.0


def test_cosine_schedule_shape():
    s = cosine_schedule(1.0, 1000, warmup_steps=100)
    assert float(s(0)) == 0.0
    assert abs(float(s(100)) - 1.0) < 1e-6
    assert float(s(1000)) < float(s(500)) < 1.0


def test_wsd_schedule_shape():
    """MiniCPM WSD: warmup ramp, flat stable phase, fast decay tail."""
    s = wsd_schedule(1.0, 1000, warmup_steps=100, decay_frac=0.1)
    assert float(s(0)) == 0.0
    assert abs(float(s(100)) - 1.0) < 1e-6
    assert abs(float(s(500)) - 1.0) < 1e-6          # stable plateau
    assert abs(float(s(899)) - 1.0) < 1e-6
    assert float(s(950)) < 0.5                       # decaying
    assert float(s(1000)) <= 0.011                   # min ratio


def test_make_schedule_dispatch():
    assert float(make_schedule("wsd", 1.0, 100)(50)) == \
        float(wsd_schedule(1.0, 100)(50))


def test_global_norm():
    t = {"a": torch.ones((3,)), "b": torch.full((4,), 2.0)}
    assert abs(float(global_norm(t)) - np.sqrt(3 + 16)) < 1e-6


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,warmup", [("cosine", 10), ("wsd", 10),
                                         ("cosine", 100), ("wsd", 100)])
def test_schedule_matches_the_reference_at_every_step(kind, warmup):
    """Every step of a 60-step run and past its end; the step as an int
    and as an int32 tensor."""
    total = 60
    ours = make_schedule(kind, 3e-3, total, warmup)
    ref = jax_optim.make_schedule(kind, 3e-3, total, warmup)
    steps = np.arange(total + 6)
    want = np.array([np.float32(ref(jnp.int32(s))) for s in steps])
    got = np.array([float(ours(int(s))) for s in steps], np.float32)
    got_t = ours(torch.from_numpy(steps.astype(np.int32))).numpy()
    assert got_t.dtype == np.float32
    np.testing.assert_allclose(got, want, **RTOL)
    np.testing.assert_allclose(got_t, want, **RTOL)


_LEAVES = {"embed": ((12, 6), "bfloat16"),
           "layers": {"w": ((2, 6, 5), "float32"),
                      "ln": ((2, 6), "bfloat16")},
           "b": ((7,), "float32")}


def _leaf_specs(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_specs(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}".lstrip("/"), v


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}".lstrip("/")] = v
    return out


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("clip", [1.0, 1e4], ids=["clipped", "unclipped"])
def test_adamw_matches_the_reference_for_five_steps(clip):
    """The same parameters (float32 and bfloat16 leaves, nested keys) and
    gradients (drawn in float32, cast to each leaf's dtype) through five
    steps of both packages' AdamW at a warming-up learning rate."""
    rng = np.random.default_rng(7)
    specs = dict(_leaf_specs(_LEAVES))
    jdt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def draw(scale):
        return {p: rng.standard_normal(shape).astype(np.float32) * scale
                for p, (shape, _) in specs.items()}

    init = draw(0.5)
    jax_p = _nest({p: jnp.asarray(init[p].astype(jdt[d]))
                   for p, (_, d) in specs.items()})
    ours = _nest({p: torch.from_numpy(init[p]).to(tdt[d])
                  for p, (_, d) in specs.items()})
    zeros = {p: np.zeros(shape, np.float32) for p, (shape, _) in specs.items()}
    jax_opt = {"m": _nest({p: jnp.asarray(z) for p, z in zeros.items()}),
               "v": _nest({p: jnp.asarray(z) for p, z in zeros.items()}),
               "count": jnp.zeros((), jnp.float32)}
    opt = {"m": _nest({p: torch.from_numpy(z.copy()) for p, z in
                       zeros.items()}),
           "v": _nest({p: torch.from_numpy(z.copy()) for p, z in
                       zeros.items()}),
           "count": torch.zeros(())}
    cfg = AdamWConfig(clip_norm=clip)
    jax_cfg = jax_optim.AdamWConfig(clip_norm=clip)
    clipped = []
    for step in range(5):
        g = draw(2.0)
        jax_g = _nest({p: jnp.asarray(g[p].astype(jdt[d]))
                       for p, (_, d) in specs.items()})
        our_g = _nest({p: torch.from_numpy(g[p]).to(tdt[d])
                       for p, (_, d) in specs.items()})
        lr = np.float32(1e-2 * (step + 1))
        jax_p, jax_opt, jm = jax_optim.adamw_update(
            jax_p, jax_g, jax_opt, jnp.float32(lr), jax_cfg)
        ours, opt, m = adamw_update(ours, our_g, opt,
                                    torch.tensor(lr), cfg)
        clipped.append(float(jm["grad_norm"]) > clip)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), **RTOL)
        for name, want in (("params", jax_p), ("m", jax_opt["m"]),
                           ("v", jax_opt["v"])):
            got = _flat(ours if name == "params" else opt[name])
            for path, x in _flat(want).items():
                assert got[path].dtype == (tdt[specs[path][1]]
                                           if name == "params"
                                           else torch.float32)
                want_np = _as_np(x)
                np.testing.assert_allclose(
                    _as_np(got[path]), want_np, rtol=1e-6,
                    atol=(1e-6 * float(np.abs(want_np).max())
                          if clip == 1.0 else 0.0),
                    err_msg=f"{name} {path} step {step}")
        assert float(opt["count"]) == float(jax_opt["count"]) == step + 1
    assert all(clipped) == (clip == 1.0) and any(clipped) == (clip == 1.0)


def test_adamw_keeps_its_scalars_on_the_device():
    """The count, the norm and the lr are 0-d tensors (nothing read on the
    host); a float lr becomes one."""
    defs = {"w": ParamDef((4,), (None,))}
    params = materialize(torch.Generator().manual_seed(0), defs)
    opt = adamw_init(defs, "cpu")
    _, opt, m = adamw_update(params, {"w": torch.ones(4, dtype=torch.bfloat16)},
                             opt, 1e-3)
    for t in (m["grad_norm"], m["lr"], opt["count"]):
        assert isinstance(t, torch.Tensor) and t.shape == ()
        assert t.dtype == torch.float32
    assert params["w"].dtype == torch.bfloat16
