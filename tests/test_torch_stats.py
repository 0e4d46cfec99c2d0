"""Welford moments, confidence intervals and stop decisions of the port
against the JAX package's on the same seeded sample streams.

Everything here is float64 host arithmetic in both packages, so the
comparisons are exact — except ``batch_state``, which the reference
folds through a float32 scan and the port reduces in float64."""

import math

import numpy as np
import pytest

from repro.core import confidence as ref_conf
from repro.core import stop_conditions as ref_stop
from repro.core import welford as ref_w
from repro_torch.core import confidence as conf
from repro_torch.core import stop_conditions as stop
from repro_torch.core import welford as w


def _stream(seed: int, n: int = 300) -> list[float]:
    rng = np.random.default_rng(seed)
    return list(rng.lognormal(mean=3.0, sigma=0.2, size=n))


def _moments(s) -> tuple[float, float, float]:
    return float(s.count), float(s.mean), float(s.m2)


def _iv(interval) -> tuple[float, float, float]:
    return interval.lo, interval.hi, interval.mean


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_fold_is_identical(seed):
    xs = _stream(seed)
    ours, ref = w.init(), ref_w.init()
    for x in xs:
        ours, ref = w.update(ours, x), ref_w.update(ref, x)
        assert _moments(ours) == _moments(ref)
    assert (ours.variance, ours.std, ours.sem, ours.cov) == \
        (ref.variance, ref.std, ref.sem, ref.cov)


def test_merge_and_tree_merge_are_identical():
    parts = [_stream(s, n) for s, n in ((3, 17), (4, 1), (5, 250), (6, 40))]
    ours = [w.from_samples(p) for p in parts]
    refs = [ref_w.from_samples(p) for p in parts]
    assert _moments(w.merge(ours[0], ours[2])) == \
        _moments(ref_w.merge(refs[0], refs[2]))
    assert _moments(w.tree_merge(ours)) == _moments(ref_w.tree_merge(refs))
    assert _moments(w.merge(w.init(), w.init())) == \
        _moments(ref_w.merge(ref_w.init(), ref_w.init()))


def test_batch_state_agrees_to_float32_rounding():
    import jax.numpy as jnp
    import torch
    xs = np.asarray(_stream(7, 500), dtype=np.float32)
    ours = w.batch_state(torch.from_numpy(xs))
    ref = ref_w.batch_state(jnp.asarray(xs))
    assert ours.count == float(ref.count) == 500.0
    # the reference accumulates in float32: its mean carries ~1e-7
    # relative error and its m2 ~n*eps relative error
    assert math.isclose(ours.mean, float(ref.mean), rel_tol=1e-6)
    assert math.isclose(ours.m2, float(ref.m2), rel_tol=1e-4)
    exact = w.from_samples(xs.astype(np.float64))
    assert math.isclose(ours.m2, exact.m2, rel_tol=1e-12)


@pytest.mark.parametrize("confidence", [0.9, 0.95, 0.99])
@pytest.mark.parametrize("use_t", [True, False])
def test_ci_mean_is_identical(confidence, use_t):
    for n in (1, 2, 5, 30, 300):
        xs = _stream(n, n)
        ours = conf.ci_mean(w.from_samples(xs), confidence, use_t)
        ref = ref_conf.ci_mean(ref_w.from_samples(xs), confidence, use_t)
        assert _iv(ours) == _iv(ref)


def test_quantiles_and_robust_statistics_are_identical():
    for p in (0.005, 0.2, 0.5, 0.975, 0.995):
        assert conf.normal_quantile(p) == ref_conf.normal_quantile(p)
        for df in (1.0, 4.0, 29.0):
            assert conf.t_quantile(p, df) == ref_conf.t_quantile(p, df)
    xs = _stream(11, 64)
    assert conf.median_of_means(xs) == ref_conf.median_of_means(xs)
    assert _iv(conf.sign_test_median_ci(xs)) == \
        _iv(ref_conf.sign_test_median_ci(xs))
    ys = _stream(12, 64)
    assert conf.spearman(xs, ys) == ref_conf.spearman(xs, ys)
    ours, ref = conf.ReservoirBootstrap(32, 50, 3), \
        ref_conf.ReservoirBootstrap(32, 50, 3)
    for x in _stream(13, 200):
        ours.update(x)
        ref.update(x)
    assert _iv(ours.ci_mean(0.99)) == _iv(ref.ci_mean(0.99))


def _contexts(mod_w, mod_stop, xs, incumbent, direction):
    state = mod_w.init()
    d = getattr(mod_stop.Direction, direction)
    for i, x in enumerate(xs, start=1):
        state = mod_w.update(state, x)
        yield mod_stop.EvalContext(welford=state, elapsed_s=0.01 * i,
                                   count=i, incumbent=incumbent, direction=d)


def _conditions(mod):
    return [mod.MaxTime(1.0), mod.MaxCount(250),
            mod.CIConverged(0.99, 0.01, min_count=5),
            mod.UpperBoundPrune(0.99, min_count=2)]


@pytest.mark.parametrize("direction", ["MAXIMIZE", "MINIMIZE"])
@pytest.mark.parametrize("incumbent", [None, 19.0, 21.0, 25.0])
def test_stop_decisions_are_identical(direction, incumbent):
    xs = _stream(21, 300)
    ours_conds, ref_conds = _conditions(stop), _conditions(ref_stop)
    n_decided = 0
    for octx, rctx in zip(_contexts(w, stop, xs, incumbent, direction),
                          _contexts(ref_w, ref_stop, xs, incumbent,
                                    direction)):
        for oc, rc in zip(ours_conds, ref_conds):
            od, rd = oc.check(octx), rc.check(rctx)
            assert (od is None) == (rd is None)
            if od is not None:
                n_decided += 1
                assert (od.reason, od.pruned) == (rd.reason, rd.pruned)
        first = stop.first_decision(ours_conds, octx)
        ref_first = ref_stop.first_decision(ref_conds, rctx)
        assert (first is None) == (ref_first is None)
    assert n_decided > 0
