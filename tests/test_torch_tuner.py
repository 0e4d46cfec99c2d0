"""The port's Tuner against the JAX package's: the same objectives (an
instant quadratic and a seeded noisy one) under every ported strategy
must visit the same configurations in the same order, prune the same
ones for the same reasons, and pick the same best configuration."""

import dataclasses
import itertools

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port


def synthetic(cfg):
    mu = 100.0 - (cfg["x"] - 7) ** 2

    def factory():
        return lambda: mu

    return factory


def noisy(cfg):
    """Quadratic surface plus seeded multiplicative noise: the sample
    stream depends only on (config, invocation, sample index), so two
    tuners that make the same decisions see the same samples."""
    base = 100.0 - 2.0 * (cfg["x"] - 6) ** 2 - 3.0 * (cfg["y"] - 1) ** 2
    invocation = itertools.count()

    def factory():
        rng = np.random.default_rng([cfg["x"], cfg["y"], next(invocation)])
        return lambda: base * (1.0 + 0.03 * rng.standard_normal())

    return factory


def _settings(mod):
    return mod.EvaluationSettings(
        max_invocations=4, max_iterations=40, max_time_s=1e6,
        use_ci_convergence=True, use_inner_prune=True,
        use_outer_prune=True)


STRATEGIES = {
    "exhaustive": lambda m: m.ExhaustiveStrategy(),
    "reverse": lambda m: m.ExhaustiveStrategy(order="reverse"),
    "shuffled": lambda m: m.ExhaustiveStrategy(order="random", seed=3),
    "random": lambda m: m.RandomSearchStrategy(budget=10, seed=5),
    "halving": lambda m: m.SuccessiveHalvingStrategy(),
    "neighborhood": lambda m: m.NeighborhoodStrategy(budget=12),
}


def _run(mod, strategy, objective, space_kw, backend=None, **tune_kw):
    tuner = mod.Tuner(mod.grid(**space_kw), _settings(mod),
                      strategy=STRATEGIES[strategy](mod))
    return tuner.tune(objective, validate="off", pipeline="off",
                      backend=backend, **tune_kw)


def _trace(result):
    return [(port.config_key(t.config), t.result.pruned,
             t.result.stop_reason, t.result.total_samples,
             t.result.score if not t.result.pruned else None)
            for t in result.trials]


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("objective,space_kw", [
    (synthetic, {"x": tuple(range(12))}),
    (noisy, {"x": tuple(range(10)), "y": (0, 1, 2)}),
], ids=["synthetic", "noisy"])
def test_same_decisions_as_the_reference(strategy, objective, space_kw):
    ours = _run(port, strategy, objective, space_kw)
    theirs = _run(ref, strategy, objective, space_kw)
    assert _trace(ours) == _trace(theirs)
    assert ours.best_config == theirs.best_config
    assert ours.best_score == theirs.best_score
    assert (ours.n_pruned, ours.total_samples, ours.strategy,
            ours.order) == (theirs.n_pruned, theirs.total_samples,
                            theirs.strategy, theirs.order)
    assert [s for _, s in ours.improvements] == \
        [s for _, s in theirs.improvements]


def test_thread_backend_finds_the_reference_optimum():
    ours = _run(port, "exhaustive", synthetic, {"x": tuple(range(12))},
                backend=port.ThreadPoolBackend(3))
    theirs = _run(ref, "exhaustive", synthetic, {"x": tuple(range(12))})
    assert ours.best_config == theirs.best_config == {"x": 7}
    assert ours.best_score == theirs.best_score == 100.0
    assert ours.backend == "thread" and ours.n_workers == 3


def test_seeded_transfer_and_warm_start_match(tmp_path):
    space = {"x": tuple(range(10)), "y": (0, 1, 2)}
    seeds = [{"x": 6, "y": 1}, {"x": 3, "y": 2}]
    results = []
    for mod in (port, ref):
        cache = mod.TrialCache(tmp_path / f"{mod.__name__}.jsonl",
                               fingerprint="fp-test").bound("noisy")
        first = _run(mod, "neighborhood", noisy, space, cache=cache,
                     seeds=seeds)
        again = _run(mod, "neighborhood", noisy, space, cache=cache,
                     warm_start=True)
        results.append((_trace(first), first.n_seeded, again.n_cached,
                        again.best_config))
    assert results[0] == results[1]


def test_unported_layers_raise_instead_of_running(tmp_path):
    """The workload audit is ported: ``validate="warn"``, the default in
    both packages, runs a benchmark without an audit spec silently, and
    ``"strict"`` raises on a mis-declared one before any trial runs. The
    run ledger is ported, so ``ledger=`` records the run the reference
    would record, through ``Tuner.tune`` and through ``TuningSession``."""
    import warnings

    import torch

    import repro.history as ref_history
    import repro_torch.history as port_history
    from repro_torch.lint import WorkloadAuditError, WorkloadSpec

    tuner = port.Tuner(port.grid(x=(1, 2)), _settings(port))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tuner.tune(synthetic).best_config == {"x": 2}
    calls = []

    def mis_declared(cfg):
        calls.append(cfg)
        return synthetic(cfg)

    mis_declared.audit_spec = lambda cfg: WorkloadSpec(
        fn=torch.matmul, args=(torch.empty(8, 8, device="meta"),) * 2,
        work=8.0, unit="flops", name="mis")
    with pytest.raises(WorkloadAuditError, match="MS101"):
        tuner.tune(mis_declared, validate="strict")
    assert calls == []
    records = []
    for mod, hist in ((port, port_history), (ref, ref_history)):
        led = hist.RunLedger(tmp_path / f"{mod.__name__}.jsonl")
        result = mod.Tuner(mod.grid(x=(1, 2)), _settings(mod)).tune(
            synthetic, validate="off", ledger=led.bound("b", "fp"),
            timestamp=5.0)
        session = mod.TuningSession(
            "s", mod.Tuner(mod.grid(x=(1, 2)), _settings(mod)), synthetic,
            cache_dir=tmp_path / mod.__name__, fingerprint="fp",
            benchmark_name="b")
        session.run(validate="off", timestamp=6.0)
        auto = hist.RunLedger(tmp_path / mod.__name__ / "history.jsonl")
        assert result.best_config == {"x": 2}
        records.append((led.series("b", "fp"), auto.series("b", "fp")))
    (port_direct, port_auto), (ref_direct, ref_auto) = records
    assert len(port_direct) == len(port_auto) == 1
    for ours, theirs in ((port_direct, ref_direct), (port_auto, ref_auto)):
        assert [dataclasses.asdict(r) for r in ours] == \
            [dataclasses.asdict(r) for r in theirs]
    assert port_auto[0].session == "s" and port_auto[0].timestamp == 6.0
