"""The port's shape-sweep layer against the JAX package's: shape keys, the
prior-warmed sweep strategy, campaigns over the synthetic GEMM family
(the same shapes, cache namespaces, per-shape trials and ledger stamps),
the config oracle's answers warm and cold, the chunked DGEMM product
against ``jnp.einsum``, and ``python -m repro_torch.sweep`` against
``scripts/sweep.py`` line for line (apart from the fingerprint and the
cache path)."""

import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.common as ref_common
import repro.core as ref
import repro.history.ledger as ref_ledger
import repro.sweep as ref_sweep
import repro_torch.core as port
import repro_torch.history.ledger as port_ledger
import repro_torch.sweep as port_sweep
from repro_torch.bench import common as port_common

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = {"port": (port, port_sweep, port_common, port_ledger),
            "ref": (ref, ref_sweep, ref_common, ref_ledger)}


def _settings(mod):
    return mod.EvaluationSettings(max_invocations=2, max_iterations=3,
                                  max_time_s=5.0, use_inner_prune=True,
                                  direction=mod.Direction.MAXIMIZE)


@pytest.mark.parametrize("shape", [{"n": 1024, "m": 512},
                                   {"a": 1, "b": 1.5, "c": "fp16"},
                                   {"k": 64}])
def test_shape_keys_are_the_references(shape):
    key = port_sweep.shape_key(shape)
    assert key == ref_sweep.shape_key(shape)
    assert port_sweep.parse_shape_key(key) == ref_sweep.parse_shape_key(key)
    name = port_sweep.shape_benchmark_name("dgemm", shape)
    assert name == ref_sweep.shape_benchmark_name("dgemm", shape)
    assert port_sweep.split_benchmark_name(name) == \
        ref_sweep.split_benchmark_name(name)
    for bad in ({}, {"m=1": 2}, {"m": "a,b"}):
        with pytest.raises(ValueError):
            port_sweep.shape_key(bad)


def _campaign(mod, sweep, common, cache_dir, **kw):
    """One campaign named ``camp`` over the quick 3x3 grid, its cache and
    ledger under ``cache_dir``."""
    return sweep.SweepCampaign(
        common.sweep_config_space(), common.gemm_shape_space(True),
        common.synthetic_gemm_family, _settings(mod), name="camp",
        cache_dir=cache_dir, fingerprint="fp", **kw)


def _outcomes(result):
    return [(o.benchmark, o.shape, o.n_trials, o.result.best_config,
             o.result.best_score, o.result.n_pruned, o.result.n_cached,
             [dict(t.config) for t in o.result.trials])
            for o in result.outcomes]


@pytest.mark.parametrize("kw", [
    {"budget_per_shape": 9, "seed": 0},
    {"budget_per_shape": 5, "seed": 3, "acquisition": "ucb"},
    {"budget_per_shape": 4, "seed": 1, "model": "knn"},
])
def test_campaign_tunes_the_same_shapes_keys_and_trials(tmp_path, kw):
    """The synthetic family over the quick 3x3 grid, one shape held out:
    the same per-shape proposals, bests and ledger records; a rerun
    serves every shape from the cache in both."""
    out = {}
    for name, (mod, sweep, common, ledger) in PACKAGES.items():
        campaign = _campaign(mod, sweep, common, tmp_path / name, **kw)
        first = campaign.run(holdout=[{"m": 512, "n": 512}], timestamp=2.0)
        again = campaign.run(holdout=[{"m": 512, "n": 512}], timestamp=3.0)
        cache = mod.TrialCache(campaign.cache_path, fingerprint="fp")
        runs = list(ledger.iter_runs(tmp_path / name / "history.jsonl"))
        out[name] = (_outcomes(first), first.total_trials,
                     [o.result.n_cached for o in again.outcomes],
                     cache.benchmarks(prefix="camp@"),
                     sorted({t.strategy for t in cache.trials()}),
                     [(r.benchmark.split("@")[1], r.run, r.config, r.score,
                       r.strategy, r.campaign, r.timestamp) for r in runs],
                     len(campaign.priors()),
                     len(campaign.priors(exclude={"m": 256, "n": 256})))
    got, want = out["port"], out["ref"]
    assert got == want
    assert got[4] == ["sweep"]
    assert len(got[0]) == 8 and len(got[5]) == 8


@pytest.mark.parametrize("model", ["ridge", "knn"])
def test_oracle_answers_are_the_references_warm_and_cold(tmp_path, model):
    queries = [{"m": 512, "n": 512}, {"m": 300, "n": 700},
               {"m": 4096, "n": 128}, {"m": 256, "n": 256}]
    out = {}
    for name, (mod, sweep, common, _) in PACKAGES.items():
        campaign = _campaign(mod, sweep, common, tmp_path / name,
                             budget_per_shape=6, seed=2, model=model)
        campaign.run(shapes=[{"m": 256, "n": 256}, {"m": 1024, "n": 512}],
                     timestamp=1.0)
        cold = campaign.oracle(min_shapes=3)        # two shapes: cold
        warm_few = campaign.oracle()                # ridge: too few trials
        campaign.run(holdout=[{"m": 512, "n": 512}], timestamp=2.0)
        warm = campaign.oracle()
        answers = {}
        for label, oracle in (("cold", cold), ("warm_few", warm_few),
                              ("warm", warm)):
            answers[label, "state"] = (oracle.is_warm(), oracle.n_trials,
                                       oracle.tuned_shapes)
            for q in queries:
                a = oracle.best_for(q)
                key = port_sweep.shape_key(q)
                answers[label, key] = (a.config, a.source, a.donor, a.cold,
                                       a.predicted)
                answers[label, key, "rank"] = oracle.rank_shapes(
                    q, min_overlap=2)
        answers["ranking"] = warm.predict(queries[0])
        out[name] = answers
    got, want = out["port"], out["ref"]
    assert got.keys() == want.keys()
    assert got["cold", "state"][0] is False
    assert got["warm", "state"][0] is True
    assert got["warm", "m=512,n=512"][1] == "model"
    assert got["cold", "m=300,n=700"][1].startswith("nearest:")
    for key in got:
        if key == "ranking":
            assert [c for c, _ in got[key]] == [c for c, _ in want[key]]
            np.testing.assert_allclose([p for _, p in got[key]],
                                       [p for _, p in want[key]], rtol=1e-9)
        elif len(key) == 2 and key[1] != "state":
            assert got[key][:4] == want[key][:4]
            np.testing.assert_allclose(got[key][4], want[key][4], rtol=1e-9)
        else:
            assert got[key] == want[key]


def test_oracle_over_trial_lists_and_empty_caches():
    for mod, sweep, common, _ in PACKAGES.values():
        oracle = sweep.ConfigOracle(common.sweep_config_space(),
                                    mod.grid(m=(256, 1024)), [], base="none")
        with pytest.raises(LookupError):
            oracle.best_for({"m": 512})
        with pytest.raises(KeyError):
            oracle.best_for({"n": 512})


def test_sweep_strategy_warmed_by_priors_proposes_the_same(tmp_path):
    out = {}
    for name, (mod, sweep, common, _) in PACKAGES.items():
        shape_space = mod.grid(m=(256, 512, 1024))
        priors = [({"m": 256}, {"bm": bm, "bn": bn},
                   100.0 - (bm / 64) - (bn / 128))
                  for bm in (16, 64, 256) for bn in (32, 128, 999)]
        strat = sweep.SweepStrategy({"m": 512}, shape_space, priors=priors,
                                    budget=7, seed=4)
        result = mod.Tuner(common.sweep_config_space(), _settings(mod),
                           strategy=strat).tune(
            common.synthetic_gemm_family({"m": 512, "n": 512}),
            validate="off")
        out[name] = ([dict(t.config) for t in result.trials],
                     result.strategy, strat._n_priors)
    assert out["port"] == out["ref"]
    assert out["port"][1] == "sweep" and out["port"][2] == 6


def test_campaign_validate_other_than_off_raises(tmp_path):
    """The campaign's ``validate`` is ported and defaults to ``"warn"``,
    as the reference's: the synthetic family declares no audit spec, so
    a strict campaign runs; a mis-declared family's strict campaign
    raises before its first trial."""
    import inspect

    from repro_torch.lint import WorkloadAuditError, WorkloadSpec
    ref_default = inspect.signature(
        ref_sweep.SweepCampaign).parameters["validate"].default
    assert _campaign(port, port_sweep, port_common, tmp_path).validate == \
        ref_default == "warn"
    result = _campaign(port, port_sweep, port_common, tmp_path / "ok",
                       validate="strict", budget_per_shape=2).run()
    assert len(result.outcomes) == 9
    calls = []

    def family(shape):
        bench = port_common.synthetic_gemm_family(shape)

        def counted(cfg):
            calls.append(cfg)
            return bench(cfg)

        counted.audit_spec = lambda cfg: WorkloadSpec(
            fn=torch.matmul, args=(torch.empty(4, 4, device="meta"),) * 2,
            work=1.0, unit="flops", name="mis")
        return counted

    campaign = port_sweep.SweepCampaign(
        port_common.sweep_config_space(), port_common.gemm_shape_space(True),
        family, _settings(port), name="camp", cache_dir=tmp_path / "bad",
        fingerprint="fp", validate="strict")
    with pytest.raises(WorkloadAuditError, match="MS101"):
        campaign.run()
    assert calls == []


@pytest.mark.parametrize("m,n,k,kc", [(64, 48, 256, 16), (33, 17, 128, 128),
                                      (128, 96, 512, 64)])
def test_chunked_dgemm_kernel_matches_jnp_einsum(m, n, k, kc):
    a, b = port_common.chunked_dgemm_data(m, n, k, kc, seed=m + n + kc,
                                          device="cpu")
    assert a.shape == (m, k // kc, kc) and b.shape == (k // kc, kc, n)
    assert a.dtype == b.dtype == torch.float32
    got = port_common.chunked_dgemm_kernel(a, b).numpy()
    want = np.asarray(ref_common.chunked_dgemm_kernel(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_chunked_dgemm_family_samples_on_the_host():
    bench = port_common.chunked_dgemm_family({"m": 64, "n": 32, "k": 64},
                                             device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    for kc in (16, 512):                      # 512 snaps down to K
        sampler = bench({"k_chunk": kc})()
        assert all(np.isfinite(sampler()) and sampler() > 0
                   for _ in range(3))
    assert port_common.sweep_chunk_space().cardinality == \
        ref_common.sweep_chunk_space().cardinality == 6
    assert port_common.SWEEP_TILES == ref_common.SWEEP_TILES
    with pytest.raises(RuntimeError, match="is_available"):
        port_common.chunked_dgemm_family({"m": 8, "n": 8})


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cli_pair(tmp_path, monkeypatch, capsys, argv):
    from repro_torch.sweep.__main__ import main
    assert main(["--session", "s", "--cache-dir", str(tmp_path / "port"),
                 "--device", "cpu", *argv]) == 0
    ours = capsys.readouterr().out.splitlines()
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    monkeypatch.setattr(sys, "argv", ["sweep.py", "--session", "s",
                                      "--cache-dir", str(tmp_path / "ref"),
                                      "--validate", "off", *argv])
    assert _load_script("sweep").main() == 0
    theirs = capsys.readouterr().out.splitlines()
    return ours, theirs


def _same_but_fingerprint_and_path(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if a.startswith(("campaign   :", "fingerprint:")):
            assert a.split(":")[0] == b.split(":")[0]
            continue
        assert a == b


@pytest.mark.parametrize("argv", [
    ["--budget-per-shape", "9", "--oracle-eval", "m=512,n=512"],
    ["--budget-per-shape", "4", "--predict", "m=768,n=640",
     "--acquisition", "ucb", "--seed", "2"],
    ["--grid", "m=256,1024;n=512", "--model", "knn", "--budget-per-shape",
     "5", "--predict", "m=300,n=512", "--oracle-eval", "m=512,n=512"],
])
def test_sweep_cli_prints_what_scripts_sweep_prints(tmp_path, monkeypatch,
                                                    capsys, argv):
    ours, theirs = _cli_pair(tmp_path, monkeypatch, capsys,
                             ["--benchmark", "synthetic", *argv])
    _same_but_fingerprint_and_path(ours, theirs)
    assert any(ln.startswith("oracle     :") for ln in ours)
    # answering from the existing cache alone, as the reference does
    ours, theirs = _cli_pair(tmp_path, monkeypatch, capsys,
                             ["--benchmark", "synthetic", "--no-tune",
                              *argv])
    _same_but_fingerprint_and_path(ours, theirs)


def test_sweep_cli_measures_a_pruned_prediction_again(tmp_path, monkeypatch,
                                                      capsys):
    """Where the predicted config was pruned in the ground-truth pass, the
    reference reports no gap; the port measures that config alone,
    unpruned, and reports it: every other line is the reference's."""
    ours, theirs = _cli_pair(tmp_path, monkeypatch, capsys, [
        "--benchmark", "synthetic", "--grid", "m=1024;n=1024",
        "--budget-per-shape", "3", "--oracle-eval", "m=256,n=256"])
    pruned = ("eval       : predicted config was pruned in the "
              "ground-truth pass")
    assert theirs[-1] == pruned + " — gap unavailable"
    assert ours[-3] == pruned + " — re-measured alone, unpruned"
    _same_but_fingerprint_and_path(ours[:-3], theirs[:-1])
    assert ours[-2] == ("eval       : optimum={'bm': 16, 'bn': 16} "
                        "score=100.000; oracle config scored 98.000 "
                        "(gap 2.00%)")
    assert ours[-1].startswith("eval       : campaign spent 3 trials vs 36")
