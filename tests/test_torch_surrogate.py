"""The port's model-guided search against the JAX package's: the feature
encoding, the ridge and k-NN surrogates' predictions, the acquisition
functions, and the whole proposal sequence of the surrogate and bandit
strategies under the same seed and space (the layer stays on numpy in
both packages, so the sequences must be identical, not merely close) —
through the Tuner on every backend shape, and through the ``tune`` CLI
against ``scripts/tune.py``."""

import importlib.util
import itertools
import pathlib
import sys

import numpy as np
import pytest

import repro.core as ref
import repro.surrogate as ref_sur
import repro_torch.core as port
import repro_torch.surrogate as port_sur

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = {"port": (port, port_sur), "ref": (ref, ref_sur)}
RTOL = 1e-12


def _spaces(mod):
    return {
        "ordinal": mod.grid(n=(256, 512, 1024), k=(64, 4096)),
        "mixed": mod.SearchSpace([mod.param("order", ("nmk", "nkm", "knm")),
                                  mod.param("n", (1, 2, 4, 8)),
                                  mod.param("fuse", (False, True))]),
        "single": mod.grid(x=(3,), y=(1, 2)),
    }


@pytest.mark.parametrize("space_name", ["ordinal", "mixed", "single"])
@pytest.mark.parametrize("with_shape", [False, True])
def test_space_encoder_features_are_the_references(space_name, with_shape):
    out = {}
    for name, (mod, sur) in PACKAGES.items():
        space = _spaces(mod)[space_name]
        shape_space = (mod.SearchSpace([mod.param("m", (256, 512, 1024)),
                                        mod.param("dt", ("f32", "bf16"))])
                       if with_shape else None)
        enc = sur.SpaceEncoder(space, shape_space=shape_space)
        configs = space.ordered("exhaustive")
        shapes = ([{"m": 256, "dt": "f32"}, {"m": 700, "dt": "bf16"},
                   {"m": 5000, "dt": "f32"}] if with_shape else [None])
        X = np.concatenate([enc.encode_all(configs, shape=s)
                            for s in shapes])
        decoded = [enc.decode(x) for x in X]
        feats = [enc.shape_features(s) for s in shapes] if with_shape \
            else []
        out[name] = (enc.dim, enc.config_dim, enc.feature_names, X, decoded,
                     feats, [sur.is_ordinal(p) for p in space.params])
    got, want = out["port"], out["ref"]
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])
    assert got[4] == want[4]
    for a, b in zip(got[5], want[5]):
        np.testing.assert_array_equal(a, b)
    assert got[6] == want[6]


def _observations(dim, n, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, size=(n, dim))
    y = 10.0 - 8.0 * ((X - 0.6) ** 2).sum(axis=1) + 0.1 * rng.standard_normal(
        n)
    return X, y


@pytest.mark.parametrize("kind", ["ridge", "knn", "auto"])
@pytest.mark.parametrize("dim,n_obs,cardinality", [(1, 0, 40), (1, 1, 40),
                                                   (2, 12, 64), (3, 30, 12),
                                                   (4, 7, 200)])
def test_surrogate_predictions_match(kind, dim, n_obs, cardinality):
    X, y = _observations(dim, n_obs, seed=dim * 100 + n_obs)
    Q = np.random.default_rng(9).uniform(-0.2, 1.2, size=(17, dim))
    out = {}
    for name, (_, sur) in PACKAGES.items():
        model = sur.make_surrogate(kind, dim, cardinality)
        half = n_obs // 2
        for x, yi in zip(X[:half], y[:half]):
            model.observe(x, float(yi))
        if n_obs:
            model.observe_many(X[half:], y[half:])
        mean, std = model.predict(Q)
        out[name] = (model.name, model.n_observed, mean, std)
    got, want = out["port"], out["ref"]
    assert got[:2] == want[:2]
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL)
    np.testing.assert_allclose(got[3], want[3], rtol=RTOL)
    assert port_sur.poly_dim(dim) == ref_sur.poly_dim(dim)


@pytest.mark.parametrize("direction", ["maximize", "minimize"])
def test_acquisition_functions_are_the_references(direction):
    rng = np.random.default_rng(4)
    mean = rng.normal(50.0, 5.0, size=40)
    std = np.abs(rng.normal(0.0, 2.0, size=40))
    std[::7] = 0.0
    out = {}
    for name, (mod, sur) in PACKAGES.items():
        d = mod.Direction(direction)
        state = mod.welford.from_samples([49.0, 51.5, 50.2, 52.0])
        best = sur.noise_adjusted_best(state, 0.99, d)
        single = sur.noise_adjusted_best(mod.welford.from_samples([3.0]),
                                         0.99, d)
        out[name] = (best, single,
                     sur.expected_improvement(mean, std, best, d),
                     sur.expected_improvement(mean, std, best, d, xi=0.0),
                     sur.upper_confidence_bound(mean, std, d),
                     sur.upper_confidence_bound(mean, std, d,
                                                confidence=0.9),
                     sur.upper_confidence_bound(mean, std, d, kappa=1.5))
    got, want = out["port"], out["ref"]
    assert got[:2] == want[:2]
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)


def noisy_surface(cfg):
    """Seeded 2-D objective (optimum a=5, b=3): the sample stream depends
    only on (config, invocation, sample), so two tuners that propose the
    same configs see the same samples."""
    mu = 100.0 - (cfg["a"] - 5) ** 2 - 0.5 * (cfg["b"] - 3) ** 2
    invocation = itertools.count()

    def factory():
        rng = np.random.default_rng([cfg["a"], cfg["b"], next(invocation)])
        return lambda: mu * (1.0 + 0.01 * rng.standard_normal())

    return factory


def noisy_cost(cfg):
    """The same surface as a cost to minimize (optimum a=5, b=3)."""
    inner = noisy_surface(cfg)

    def factory():
        sample = inner()
        return lambda: 200.0 - sample()

    return factory


def _settings(mod, direction="maximize"):
    return mod.EvaluationSettings(
        max_invocations=3, max_iterations=20, max_time_s=1e6,
        use_ci_convergence=True, use_inner_prune=True, use_outer_prune=True,
        direction=mod.Direction(direction))


def _surface(mod, constrained=False):
    space = mod.grid(a=tuple(range(8)), b=tuple(range(8)))
    if constrained:
        space = space.constrain(lambda c: (c["a"] + c["b"]) % 3 != 0)
    return space


def _sequence(result):
    return ([(port.config_key(t.config), t.result.pruned,
              t.result.total_samples) for t in result.trials],
            [b.size for b in result.batches],
            result.best_config, result.n_seeded)


STRATEGIES = {
    "surrogate_ei": lambda s: s.SurrogateStrategy(budget=20, seed=7),
    "surrogate_ucb": lambda s: s.SurrogateStrategy(budget=20, seed=7,
                                                   acquisition="ucb"),
    "surrogate_ridge": lambda s: s.SurrogateStrategy(budget=18, seed=2,
                                                     model="ridge"),
    "surrogate_knn_batched": lambda s: s.SurrogateStrategy(
        budget=16, seed=3, model="knn", batch=3, n_init=4),
    "surrogate_unbounded": lambda s: s.SurrogateStrategy(seed=1),
    "bandit": lambda s: s.BanditStrategy(budget=20, seed=7),
    "bandit_batched": lambda s: s.BanditStrategy(budget=24, seed=11,
                                                 batch=4),
}


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("variant", ["plain", "seeded", "minimize",
                                     "constrained", "rounds"])
def test_whole_proposal_sequence_is_the_references(strategy, variant):
    out = {}
    for name, (mod, sur) in PACKAGES.items():
        minimize = variant == "minimize"
        direction = "minimize" if minimize else "maximize"
        objective = noisy_cost if minimize else noisy_surface
        tuner = mod.Tuner(_surface(mod, variant == "constrained"),
                          _settings(mod, direction),
                          strategy=STRATEGIES[strategy](sur))
        backend = (mod.SimulatedShardedBackend(4) if variant == "rounds"
                   else None)
        seeds = ([{"a": 2, "b": 2}, {"a": 6, "b": 1}]
                 if variant == "seeded" else ())
        result = tuner.tune(objective, seeds=seeds, backend=backend,
                            validate="off", pipeline="off")
        out[name] = _sequence(result)
        assert result.strategy == STRATEGIES[strategy](sur).name
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) > 0


@pytest.mark.parametrize("which", ["surrogate", "bandit"])
def test_ask_tell_driven_by_hand_matches(which):
    """The strategies alone, with outcomes fed back by hand (pruned ones
    among them), propose the same configurations."""
    out = {}
    for name, (mod, sur) in PACKAGES.items():
        space = _surface(mod)
        settings = _settings(mod)
        strat = (sur.SurrogateStrategy(budget=30, seed=5, batch=2)
                 if which == "surrogate"
                 else sur.BanditStrategy(budget=30, seed=5, batch=2))
        strat.reset(space, settings, seeds=[{"a": 1, "b": 1}])
        proposed = []
        while True:
            batch = strat.ask(None)
            if batch is None:
                break
            for cfg in batch.configs:
                proposed.append(dict(cfg))
                score = 100.0 - (cfg["a"] - 5) ** 2 - (cfg["b"] - 3) ** 2
                st = mod.welford.from_samples([score - 0.5, score + 0.5,
                                               score])
                inv = mod.InvocationResult(
                    mean=float(st.mean), count=int(st.count),
                    elapsed_s=0.01, stop_reason="max_count(3)",
                    pruned=score < 80.0, m2=float(st.m2))
                strat.tell(cfg, mod.EvalResult(
                    score=score, best_invocation=score, invocations=(inv,),
                    total_samples=3, total_time_s=0.01,
                    measured_time_s=0.01, pruned=score < 80.0,
                    stop_reason="x"))
        out[name] = proposed
    assert out["port"] == out["ref"]
    assert len(out["port"]) == 30


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _trial_lines(text: str) -> list[str]:
    keep = ("  [", "best      :", "trials    :", "strategy  :",
            "strategy   :", "incumbent :")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


@pytest.mark.parametrize("argv", [
    ["--strategy", "surrogate", "--budget", "7", "--seed", "0"],
    ["--strategy", "surrogate", "--budget", "7", "--seed", "3",
     "--acquisition", "ucb"],
    ["--strategy", "bandit", "--budget", "6", "--seed", "1"],
])
def test_tune_cli_proposes_what_scripts_tune_proposes(tmp_path, monkeypatch,
                                                      capsys, argv):
    from repro_torch import tune
    common = ["--benchmark", "synthetic", "--history", *argv]
    assert tune.main(["--session", "p", "--cache-dir", str(tmp_path / "p"),
                      "--device", "cpu", *common]) == 0
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", [
        "tune.py", "--session", "r", "--cache-dir", str(tmp_path / "r"),
        "--validate", "off", *common])
    assert _load_script("tune").main() == 0
    theirs = capsys.readouterr().out
    assert _trial_lines(ours) == _trial_lines(theirs)
    assert len([ln for ln in _trial_lines(ours) if ln.startswith("  [")]) \
        == int(argv[3])
    assert "history   : ▄  (1 run(s))" in ours
    assert "perf-gate: 1 series, 0 confirmed regression(s)" in ours
