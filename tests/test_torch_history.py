"""The port's performance-history layer against the JAX package's: the run
ledger (one on-disk format, read and written by both; compaction,
backfill and record distillation), the regression gate's statistics and
verdicts, the terminal and HTML renderings (byte for byte, against the
reference's golden files), and the CLIs over them — ``perf_gate``,
``tune --compact-history``, ``roofline_report --html`` and
``bench.run --html`` — on the same inputs as their reference scripts.
Everything runs on the host: the ledger and the renderings read records
only."""

import dataclasses
import importlib.util
import itertools
import json
import pathlib
import sys
import time

import numpy as np
import pytest

import repro.core as ref
import repro.history as ref_history
import repro.history.ledger as ref_ledger
import repro_torch.core as port
import repro_torch.history as port_history
import repro_torch.history.ledger as port_ledger

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
PACKAGES = {"port": (port, port_history), "ref": (ref, ref_history)}
RTOL = 1e-12


def make_record(mod, hist, score, offsets=(0.5, 0.7, 0.4, 0.6, 0.5), run=0,
                benchmark="dgemm", fingerprint="fp", **kw):
    """RunRecord whose moments come from real sample streams: one
    3-sample invocation per offset, each with mean exactly ``score``
    (the fixture of ``tests/test_history.py``)."""
    states = [mod.welford.from_samples([score - o, score + o, score])
              for o in offsets]
    pooled = mod.welford.tree_merge(states)
    return hist.RunRecord(
        benchmark=benchmark, fingerprint=fingerprint, run=run,
        config={"n": 512}, score=score, count=float(pooled.count),
        mean=float(pooled.mean), m2=float(pooled.m2),
        invocation_means=tuple(float(s.mean) for s in states), **kw)


def _as_dicts(records) -> list[dict]:
    return [dataclasses.asdict(r) for r in records]


def _noisy(cfg):
    """A seeded noisy quadratic: the sample stream depends only on
    (config, invocation, sample), so both tuners see the same samples."""
    base = 100.0 - (cfg["x"] - 5) ** 2
    invocation = itertools.count()

    def factory():
        rng = np.random.default_rng([cfg["x"], next(invocation)])
        return lambda: base * (1.0 + 0.02 * rng.standard_normal())

    return factory


def _settings(mod):
    return mod.EvaluationSettings(
        max_invocations=3, max_iterations=12, max_time_s=1e6,
        use_ci_convergence=True, use_inner_prune=True, use_outer_prune=True)


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_ref_main(script, argv, monkeypatch, capsys) -> tuple[int, str]:
    monkeypatch.setattr(sys, "argv", [f"{script.__name__}.py", *argv])
    rc = script.main()
    return rc, capsys.readouterr().out


# ---------------------------------------------------------------------------
# Ledger: one format, read and written by both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_records_written_by_one_package_read_back_equal_in_the_other(
        tmp_path, writer, reader):
    w_mod, w_hist = PACKAGES[writer]
    r_mod, r_hist = PACKAGES[reader]
    path = tmp_path / "history.jsonl"
    written = w_hist.RunLedger(path)
    for k, score in enumerate((100.0, 98.0, 103.5)):
        written.append(make_record(
            w_mod, w_hist, score, strategy="surrogate", session="s",
            timestamp=1.7e9 + k, direction="maximize",
            campaign="c" if k == 1 else None, n_trials=12,
            total_samples=90))
    written.append(make_record(w_mod, w_hist, 7.0, benchmark="triad",
                               direction="minimize"))
    read = r_hist.RunLedger(path)
    assert read.keys() == written.keys()
    for key in written.keys():
        assert _as_dicts(read.series(*key)) == \
            _as_dicts(written.series(*key))
    # appending through the reader continues the writer's run indices
    assert read.append(make_record(r_mod, r_hist, 99.0)).run == 3


def test_both_packages_append_identical_bytes(tmp_path):
    for name, (mod, hist) in PACKAGES.items():
        led = hist.RunLedger(tmp_path / f"{name}.jsonl")
        led.append(make_record(mod, hist, 100.0, strategy="exhaustive",
                               settings_key="abc", timestamp=5.0))
        led.append(make_record(mod, hist, 91.25, session="nightly"))
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()


def _tuned(mod, tmp_path, name):
    """One seeded noisy session per package, through its TuningSession,
    into its own cache dir (and so its own AUTO ledger)."""
    session = mod.TuningSession(
        "s", mod.Tuner(mod.grid(x=tuple(range(9))), _settings(mod)), _noisy,
        cache_dir=tmp_path / name, fingerprint="fp", benchmark_name="noisy")
    return session.run(validate="off", timestamp=1234.5)


def test_record_from_result_and_the_session_ledger_match(tmp_path):
    results = {name: _tuned(mod, tmp_path, name)
               for name, (mod, _) in PACKAGES.items()}
    distilled = {
        name: hist.record_from_result("noisy", "fp", results[name],
                                      settings_key="k", session="s",
                                      timestamp=3.0, campaign="c")
        for name, (_, hist) in PACKAGES.items()}
    assert distilled["port"] is not None
    assert dataclasses.asdict(distilled["port"]) == \
        dataclasses.asdict(distilled["ref"])
    # the record every completed session appends, byte for byte
    assert (tmp_path / "port" / "history.jsonl").read_bytes() == \
        (tmp_path / "ref" / "history.jsonl").read_bytes()
    rec = port_history.RunLedger(
        tmp_path / "port" / "history.jsonl").series("noisy", "fp")
    assert [(r.run, r.session, r.timestamp) for r in rec] == \
        [(0, "s", 1234.5)]


def test_compact_gives_the_same_survivors(tmp_path):
    scores = (100.0, 104.0, 101.0, 99.0, 98.0, 97.5, 103.0, 96.0)
    for name, (mod, hist) in PACKAGES.items():
        path = tmp_path / f"{name}.jsonl"
        led = hist.RunLedger(path)
        for s in scores:
            led.append(make_record(mod, hist, s))
            led.append(make_record(mod, hist, 200.0 - s, benchmark="lat",
                                   direction="minimize"))
        with open(path, "a", encoding="utf-8") as f:
            f.write('{"version": 1, "foreign": true}\n')
        dropped = led.compact(keep_last=3)
        assert dropped == 8
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    kept = port_history.RunLedger(tmp_path / "port.jsonl")
    assert [r.run for r in kept.series("dgemm", "fp")] == [1, 5, 6, 7]


@pytest.mark.parametrize("direction", ["maximize", "minimize"])
def test_backfill_gives_the_same_records(tmp_path, direction):
    for name, (mod, hist) in PACKAGES.items():
        cache = mod.TrialCache(tmp_path / f"{name}.jsonl", fingerprint="fp")
        mod.Tuner(mod.grid(x=tuple(range(9))), _settings(mod)).tune(
            _noisy, cache=cache.bound("noisy"), validate="off")
        led = hist.RunLedger(tmp_path / f"{name}-h.jsonl")
        added = led.backfill(cache, session="bf",
                             direction=mod.Direction(direction))
        assert len(added) == 1
        assert led.backfill(tmp_path / f"{name}.jsonl") == []  # idempotent
    assert (tmp_path / "port-h.jsonl").read_bytes() == \
        (tmp_path / "ref-h.jsonl").read_bytes()


def test_the_ledger_and_the_caches_skip_each_others_lines(tmp_path):
    """A ledger beside session caches: ``load_trials`` on the directory,
    ``TrialCache`` and ``build_reports`` ignore its lines, and a ledger
    reads no trial record — in both packages, on the port's files."""
    settings = _settings(port)
    for bench, space in (("dgemm", port.grid(n=(256, 512), m=(256,),
                                             k=(64,))),
                         ("triad", port.grid(n_bytes=(1 << 22, 1 << 28)))):
        port.TuningSession(
            "c", port.Tuner(space, settings), _deterministic,
            cache_dir=tmp_path, fingerprint="fp",
            benchmark_name=bench).run(timestamp=1.0)
    history = tmp_path / "history.jsonl"
    assert len(port_history.RunLedger(history)) == 2
    for mod in (port, ref):
        trials = mod.load_trials(tmp_path)
        assert sorted({t.benchmark for t in trials}) == ["dgemm", "triad"]
        assert len(trials) == 4
        reports, skipped = mod.build_reports(trials)
        assert [r.fingerprint for r in reports] == ["fp"] and not skipped
        assert len(mod.TrialCache(history, fingerprint="fp")) == 0
    for led in (port_ledger, ref_ledger):
        assert list(led.iter_runs(tmp_path / "c.jsonl")) == []


def _deterministic(cfg):
    score = (cfg["n_bytes"] / 1e6 if "n_bytes" in cfg
             else cfg["n"] * cfg["m"] * cfg["k"] / 1e7)
    invocation = itertools.count()

    def factory():
        inv = next(invocation)
        ticks = itertools.count()
        return lambda: score * (1.0 + 0.01 * ((next(ticks) + inv) % 5 - 2))

    return factory


def test_bound_ledger_records_through_the_tuner(tmp_path):
    results = {}
    for name, (mod, hist) in PACKAGES.items():
        led = hist.RunLedger(tmp_path / f"{name}.jsonl")
        bound = led.bound("noisy", "fp", session="b", campaign="cc")
        mod.Tuner(mod.grid(x=tuple(range(9))), _settings(mod)).tune(
            _noisy, ledger=bound, timestamp=9.0, validate="off")
        results[name] = _as_dicts(bound.series())
    assert len(results["port"]) == 1
    assert results["port"] == results["ref"]


# ---------------------------------------------------------------------------
# Regression gate statistics
# ---------------------------------------------------------------------------


def _state(mod, samples):
    return mod.welford.from_samples(samples)


@pytest.mark.parametrize("a,b", [
    ([1.0, 2.0, 3.0, 4.0], [2.0, 3.0, 5.0, 6.0, 7.5]),
    ([100.0, 100.5, 99.5] * 3, [95.0, 96.0, 94.0, 95.5]),
    ([5.0], [1.0, 2.0]),                       # < 2 samples: infinite
    ([3.0, 3.0, 3.0], [4.0, 4.0]),             # zero variance: exact
])
@pytest.mark.parametrize("confidence", [0.95, 0.99])
def test_welch_interval_matches(a, b, confidence):
    got = port_history.welch_interval(_state(port, a), _state(port, b),
                                      confidence)
    want = ref_history.welch_interval(_state(ref, a), _state(ref, b),
                                      confidence)
    np.testing.assert_allclose([got.lo, got.hi, got.mean],
                               [want.lo, want.hi, want.mean], rtol=RTOL)


CASES = {
    # (baseline score, candidate score, offsets, direction)
    "flat": (100.0, 100.2, (0.5, 0.7, 0.4, 0.6, 0.5), "maximize"),
    "regressed": (100.0, 90.0, (0.5, 0.7, 0.4, 0.6, 0.5), "maximize"),
    "improved": (100.0, 110.0, (0.5, 0.7, 0.4, 0.6, 0.5), "maximize"),
    "minimize_up": (100.0, 110.0, (0.5, 0.7, 0.4, 0.6, 0.5), "minimize"),
    "small_effect": (100.0, 99.0, (0.01, 0.02, 0.01, 0.02, 0.01),
                     "maximize"),
    "two_invocations": (100.0, 90.0, (0.5, 0.7), "maximize"),
}


def _pair(mod, hist, case):
    base, cand, offsets, direction = CASES[case]
    a = make_record(mod, hist, base, offsets=offsets, run=0,
                    direction=direction)
    b = make_record(mod, hist, cand, offsets=offsets, run=3,
                    direction=direction)
    return a, b


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("min_count", [5, 100])
def test_compare_runs_matches(case, min_count):
    """Welch path (min_count 5) and the reservoir-bootstrap fallback
    (min_count 100 puts every run below it)."""
    out = {}
    for name, (mod, hist) in PACKAGES.items():
        a, b = _pair(mod, hist, case)
        out[name] = hist.compare_runs(a, b, confidence=0.99,
                                      min_count=min_count)
    got, want = out["port"], out["ref"]
    assert (got.verdict, got.method) == (want.verdict, want.method)
    assert got.method == ("welch" if min_count == 5 else "bootstrap")
    np.testing.assert_allclose(
        [got.delta, got.rel_delta, got.interval.lo, got.interval.hi,
         got.interval.mean],
        [want.delta, want.rel_delta, want.interval.lo, want.interval.hi,
         want.interval.mean], rtol=RTOL)


def _gate_ledger(mod, hist, path):
    led = hist.RunLedger(path)
    for s in (100.0, 104.0, 101.0, 93.0):      # newest 10.6% under the best
        led.append(make_record(mod, hist, s, strategy="exhaustive"))
    for s in (50.0, 50.1):                     # flat
        led.append(make_record(mod, hist, s, benchmark="triad"))
    led.append(make_record(mod, hist, 7.0, benchmark="synthetic",
                           fingerprint="fp2"))  # single run: baseline
    for s in (20.0, 23.0):                     # slower under minimize
        led.append(make_record(mod, hist, s, benchmark="latency",
                               direction="minimize"))
    return led


@pytest.mark.parametrize("kwargs", [{}, {"benchmark": "dgemm"},
                                    {"fingerprint": "fp2"},
                                    {"min_effect": 0.2, "confidence": 0.95},
                                    {"min_count": 50}])
def test_detect_regressions_matches(tmp_path, kwargs):
    reports = {}
    for name, (mod, hist) in PACKAGES.items():
        led = _gate_ledger(mod, hist, tmp_path / f"{name}.jsonl")
        reports[name] = hist.detect_regressions(led, **kwargs)
    got, want = reports["port"], reports["ref"]
    assert [(s.benchmark, s.fingerprint, s.verdict) for s in got.series] == \
        [(s.benchmark, s.fingerprint, s.verdict) for s in want.series]
    assert got.ok == want.ok
    for g, w in zip(got.series, want.series):
        if w.comparison is None:
            assert g.comparison is None
            continue
        np.testing.assert_allclose(
            [g.comparison.delta, g.comparison.interval.lo,
             g.comparison.interval.hi],
            [w.comparison.delta, w.comparison.interval.lo,
             w.comparison.interval.hi], rtol=RTOL)
        assert g.comparison.baseline.run == w.comparison.baseline.run
    assert got.render_text() == want.render_text()
    if not kwargs:
        assert [s.verdict for s in got.series] == [
            "regressed", "regressed", "baseline", "flat"]


# ---------------------------------------------------------------------------
# Rendering, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("values", [[], [5.0, 5.0, 5.0],
                                    [0, 1, 2, 3, 4, 5, 6, 7], [1.0, 0.0],
                                    [3.2, 9.9, 1.1, 4.4, 4.4]])
def test_ascii_sparkline_is_the_reference(values):
    assert port_history.ascii_sparkline(values) == \
        ref_history.ascii_sparkline(values)


def test_render_trend_text_is_the_reference():
    texts = []
    for mod, hist in PACKAGES.values():
        runs = [make_record(mod, hist, 100.0, run=0, strategy="exhaustive",
                            session="s"),
                make_record(mod, hist, 90.0, run=1),
                make_record(mod, hist, 95.5, run=2, offsets=(0.0,),
                            strategy="surrogate")]
        texts.append(hist.render_trend_text(runs))
        assert hist.render_trend_text([]) == "(no history yet)"
    assert texts[0] == texts[1]
    assert "3 run(s)" in texts[0] and "via surrogate" in texts[0]


def _eval_result(mod, score, spreads=(1.0, 2.0)):
    invs, samples = [], 0
    for off in spreads:
        st = mod.welford.from_samples([score - off, score + off])
        samples += int(st.count)
        invs.append(mod.InvocationResult(
            mean=float(st.mean), count=int(st.count), elapsed_s=0.125,
            pruned=False, stop_reason="max_count(2)", m2=float(st.m2)))
    return mod.EvalResult(score=score, best_invocation=score,
                          invocations=tuple(invs), total_samples=samples,
                          total_time_s=0.25, measured_time_s=0.25,
                          pruned=False, stop_reason="max_count(2)")


def _dashboard_inputs(tmp_path):
    """The port's copy of the fixture of
    ``tests/test_history.py::test_html_dashboard_matches_golden``."""
    trials = [
        port.CachedTrial("dgemm", "fpA", {"n": 512, "m": 512, "k": 128},
                         _eval_result(port, 120.0)),
        port.CachedTrial("triad", "fpA", {"n_bytes": 1 << 22},
                         _eval_result(port, 40.0)),
        port.CachedTrial("triad", "fpA", {"n_bytes": 1 << 28},
                         _eval_result(port, 10.0)),
    ]
    reports, skipped = port.build_reports(trials)
    led = port_history.RunLedger(tmp_path / "h.jsonl")
    for score, strategy, ts in ((118.0, "exhaustive", 1700000000.0),
                                (120.0, "exhaustive", 1700086400.0),
                                (112.0, "random", 1700172800.0)):
        led.append(make_record(port, port_history, score, fingerprint="fpA",
                               strategy=strategy, session="nightly",
                               timestamp=ts))
    return reports, skipped, led


def test_html_dashboard_is_the_golden_file(tmp_path):
    reports, skipped, led = _dashboard_inputs(tmp_path)
    html = port_history.render_html(
        reports, skipped, ledger=led,
        regression=port_history.detect_regressions(led),
        subtitle="golden fixture")
    assert html == (GOLDEN / "dashboard.html").read_text(encoding="utf-8")


TRIAL_ROWS = [
    {"index": 0, "config": {"x": 0}, "score": 75.0, "pruned": False,
     "stop_reason": "converged", "samples": 30, "worker": 0,
     "thread": "w0", "tid": 1, "ts": 0.001, "dur_s": 0.0123,
     "invocations": 2, "phases": {"measure": 0.0101, "cache_io": 0.0004},
     "improved": True, "cached": False},
    {"index": 1, "config": {"x": 1}, "score": 84.0, "pruned": True,
     "stop_reason": "outer_pruned", "samples": 6, "worker": 1,
     "thread": "w1", "tid": 2, "ts": 0.002, "dur_s": 0.0042,
     "invocations": 1, "phases": {"measure": 0.0031},
     "improved": False, "cached": False},
    {"index": None, "config": {"x": 2}, "score": 91.0, "pruned": False,
     "stop_reason": "converged", "samples": 30, "worker": None,
     "thread": None, "tid": None, "ts": 0.003, "dur_s": 0.0,
     "invocations": 0, "phases": {}, "improved": False, "cached": True},
]


def test_trial_drilldown_is_the_golden_file():
    """The rows of ``tests/test_obs.py::test_dashboard_trial_drilldown_golden``."""
    html = port_history.render_html(trials=TRIAL_ROWS,
                                    subtitle="golden fixture")
    assert html == (GOLDEN / "dashboard_trials.html").read_text(
        encoding="utf-8")


@pytest.mark.parametrize("max_rows", [1, 200])
def test_render_html_matches_the_reference_on_other_inputs(tmp_path,
                                                           max_rows):
    """Ledger-only, trial-capped, empty and single-run renders."""
    outs = []
    for name, (mod, hist) in PACKAGES.items():
        led = hist.RunLedger(tmp_path / f"{name}.jsonl")
        led.append(make_record(mod, hist, 100.0))
        one = hist.RunLedger(tmp_path / f"{name}-one.jsonl")
        one.append(make_record(mod, hist, 100.0, benchmark="single"))
        led.append(make_record(mod, hist, 97.0, timestamp=1.0))
        outs.append((
            hist.render_html(ledger=led, title="t <&>", confidence=0.95,
                             skipped=[("fpX", "no triad")]),
            hist.render_html(trials=TRIAL_ROWS, max_trial_rows=max_rows),
            hist.render_html(),
            hist.render_html(ledger=one,
                             regression=hist.detect_regressions(one))))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# CLIs on the same inputs as the reference scripts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv,code", [
    ([], 1), (["--dry-run"], 0), (["--benchmark", "triad"], 0),
    (["--min-effect", "0.2"], 0), (["--direction", "maximize"], 1),
    (["--fingerprint", "fp2", "--confidence", "0.9"], 0),
])
@pytest.mark.parametrize("actions", [False, True])
def test_perf_gate_is_the_reference(tmp_path, monkeypatch, capsys, argv,
                                    code, actions):
    from repro_torch import perf_gate
    if actions:
        monkeypatch.setenv("GITHUB_ACTIONS", "true")
    else:
        monkeypatch.delenv("GITHUB_ACTIONS", raising=False)
    path = tmp_path / "history.jsonl"
    _gate_ledger(port, port_history, path)
    assert perf_gate.main([str(path), *argv]) == code
    ours = capsys.readouterr().out
    rc, theirs = _run_ref_main(_load_script("perf_gate"), [str(path), *argv],
                               monkeypatch, capsys)
    assert rc == code and ours == theirs
    assert ("::error" in ours) == (actions and code == 1)


def test_perf_gate_missing_ledger(tmp_path, capsys):
    from repro_torch import perf_gate
    assert perf_gate.main([str(tmp_path / "no.jsonl")]) == 2
    assert perf_gate.main([str(tmp_path / "no.jsonl"), "--dry-run"]) == 0
    assert "nothing to gate (dry-run, ok)" in capsys.readouterr().out


def test_tune_compact_history_runs_standalone(tmp_path, monkeypatch,
                                              capsys):
    """No --session, no device: compacts <cache-dir>/history.jsonl as
    ``scripts/tune.py --compact-history`` does."""
    from repro_torch import tune
    outs = {}
    for name, (mod, hist) in PACKAGES.items():
        d = tmp_path / name
        led = hist.RunLedger(d / "history.jsonl")
        for s in (100.0, 104.0, 101.0, 99.0, 98.0):
            led.append(make_record(mod, hist, s))
        argv = ["--compact-history", "2", "--cache-dir", str(d)]
        if name == "port":
            assert tune.main(argv) == 0
            outs[name] = capsys.readouterr().out
        else:
            rc, outs[name] = _run_ref_main(_load_script("tune"), argv,
                                           monkeypatch, capsys)
            assert rc == 0
    assert outs["port"].replace("port", "X") == outs["ref"].replace("ref",
                                                                    "X")
    assert "dropped 2 of 5 run(s), kept 3" in outs["port"]
    assert (tmp_path / "port" / "history.jsonl").read_bytes() == \
        (tmp_path / "ref" / "history.jsonl").read_bytes()
    assert tune.main(["--compact-history", "2", "--cache-dir",
                      str(tmp_path / "none")]) == 0
    assert "nothing to do" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tune.main(["--benchmark", "synthetic", "--device", "cpu"])


def _report_inputs(tmp_path):
    """A roofline-complete cache, a ledger with a regression and a session
    trace, all written by the port."""
    settings = port.EvaluationSettings(max_invocations=3, max_iterations=12,
                                       max_time_s=1e6,
                                       use_ci_convergence=True)
    spaces = {"dgemm": port.grid(n=(256, 512), m=(256,), k=(64, 128)),
              "triad": port.grid(n_bytes=(1 << 22, 1 << 28))}
    for bench, space in spaces.items():
        port.TuningSession("report", port.Tuner(space, settings),
                           _deterministic, cache_dir=tmp_path,
                           fingerprint="cuda:NVIDIA H100 80GB HBM3:sm90:n1",
                           benchmark_name=bench,
                           trace=tmp_path / f"{bench}.trace.jsonl").run(
            timestamp=1.7e9)
    led = port_history.RunLedger(tmp_path / "history.jsonl")
    led.append(make_record(port, port_history, 93.0, benchmark="dgemm",
                           fingerprint="fp", timestamp=1.8e9))
    led.append(make_record(port, port_history, 80.0, benchmark="dgemm",
                           fingerprint="fp", timestamp=1.9e9))
    return tmp_path / "report.jsonl", tmp_path / "history.jsonl"


@pytest.mark.parametrize("extra", [[], ["--confidence", "0.95",
                                        "--max-trial-rows", "2"]])
def test_roofline_report_html_is_the_reference(tmp_path, monkeypatch,
                                               capsys, extra):
    from repro_torch import roofline_report
    cache, ledger = _report_inputs(tmp_path)
    trace = tmp_path / "dgemm.trace.jsonl"
    monkeypatch.setattr(time, "strftime", lambda *a: "2026-01-02 03:04 UTC")
    common = [str(cache), "--history", str(ledger), "--trace", str(trace),
              "--out", str(tmp_path / "r.md"), *extra]
    assert roofline_report.main([*common, "--html",
                                 str(tmp_path / "ours.html")]) == 0
    rc, _ = _run_ref_main(_load_script("roofline_report"),
                          [*common, "--html", str(tmp_path / "ref.html")],
                          monkeypatch, capsys)
    assert rc == 0
    ours = (tmp_path / "ours.html").read_bytes()
    assert ours == (tmp_path / "ref.html").read_bytes()
    for section in (b"Roofline \xe2\x80\x94 <code>cuda:NVIDIA H100",
                    b"Trend \xe2\x80\x94 dgemm @ <code>fp</code>",
                    b"Trial drill-down", b"verdict-regressed"):
        assert section in ours
    # a missing ledger or trace is a usage error, as in the reference
    for flag in ("--history", "--trace"):
        argv = [str(cache), "--out", str(tmp_path / "r.md"), "--html",
                str(tmp_path / "x.html"), flag, str(tmp_path / "missing")]
        assert roofline_report.main(argv) == 2


def test_roofline_report_ledger_only_still_writes(tmp_path, monkeypatch,
                                                  capsys):
    """No roofline-complete fingerprint, but --html with --history: every
    requested file is written, byte for byte the reference's."""
    from repro_torch import roofline_report
    cache = tmp_path / "synthetic-only.jsonl"
    port.TrialCache(cache, fingerprint="fpA").put(
        "synthetic", {"x": 5}, _eval_result(port, 100.0))
    led = port_history.RunLedger(tmp_path / "h.jsonl")
    led.append(make_record(port, port_history, 100.0, benchmark="synthetic",
                           fingerprint="fpA"))
    monkeypatch.setattr(time, "strftime", lambda *a: "2026-01-02 03:04 UTC")
    for who in ("ours", "ref"):
        argv = [str(cache), "--out", str(tmp_path / f"{who}.md"), "--csv",
                str(tmp_path / f"{who}.csv"), "--html",
                str(tmp_path / f"{who}.html"), "--history",
                str(tmp_path / "h.jsonl")]
        if who == "ours":
            assert roofline_report.main(argv) == 0
        else:
            assert _run_ref_main(_load_script("roofline_report"), argv,
                                 monkeypatch, capsys)[0] == 0
    for ext in ("md", "csv", "html"):
        assert (tmp_path / f"ours.{ext}").read_bytes() == \
            (tmp_path / f"ref.{ext}").read_bytes()
    assert roofline_report.main([str(cache), "--out",
                                 str(tmp_path / "r.md")]) == 1


def test_bench_run_html_is_the_reference(tmp_path, monkeypatch, capsys):
    """``bench.run --html`` over a cache dir holding sessions and their
    ledger writes the reference's ``benchmarks/run.py --html`` bytes."""
    import benchmarks.run as ref_run
    from repro_torch.bench import run as bench_run
    _report_inputs(tmp_path / "cache")
    monkeypatch.setattr(time, "strftime", lambda *a: "2026-01-02 03:04 UTC")
    monkeypatch.setitem(bench_run.BENCHES, "triad", lambda **_: None)
    monkeypatch.setitem(ref_run.BENCHES, "triad", lambda **_: None)
    argv = ["--only", "triad", "--resume", str(tmp_path / "cache"),
            "--html"]
    assert bench_run.main([*argv, str(tmp_path / "ours.html"), "--device",
                           "cpu"]) == 0
    monkeypatch.setattr(sys, "argv",
                        ["run.py", *argv, str(tmp_path / "ref.html")])
    ref_run.main()
    ours = (tmp_path / "ours.html").read_bytes()
    assert ours == (tmp_path / "ref.html").read_bytes()
    assert b"Regression verdicts" in ours and b"Roofline" in ours


def test_the_port_reads_reference_ledgers_in_the_gate(tmp_path, capsys):
    """A ledger the JAX package wrote gates the same in the port."""
    from repro_torch import perf_gate
    path = tmp_path / "history.jsonl"
    _gate_ledger(ref, ref_history, path)
    assert perf_gate.main([str(path)]) == 1
    out = capsys.readouterr().out
    assert "REGRESSED" in out and "CI [" in out
    assert json.loads(path.read_text().splitlines()[0])["ledger_version"] == 1
