"""Carried state: the port's trial cache is the JAX package's format byte
for byte, each package reads what the other wrote, settings keys agree,
and both render the same roofline dashboard from the same trials."""

import dataclasses
import itertools

import pytest

import repro.core as ref
import repro.core.report as ref_report
import repro_torch.core as port
import repro_torch.core.report as port_report

FP = "cuda:NVIDIA H100 80GB HBM3:sm90:n1:torch-x+cu12.8"


def _objective(cfg):
    """Deterministic per-sample stream, different per config."""
    score = (cfg["n_bytes"] / 1e6 if "n_bytes" in cfg
             else cfg["n"] * cfg["m"] * cfg["k"] / 1e7)
    invocation = itertools.count()

    def factory():
        inv = next(invocation)
        ticks = itertools.count()
        return lambda: score * (1.0 + 0.01 * ((next(ticks) + inv) % 5 - 2))

    return factory


def _settings(mod):
    return mod.EvaluationSettings(max_invocations=3, max_iterations=12,
                                  max_time_s=1e6, use_ci_convergence=True)


def _tune_into(mod, path, fingerprint=FP):
    """One dgemm-like and one triad-like session into ``path``."""
    spaces = {"dgemm": mod.grid(n=(256, 512), m=(256,), k=(64, 128)),
              "triad": mod.grid(n_bytes=(1 << 22, 1 << 28))}
    cache = mod.TrialCache(path, fingerprint=fingerprint)
    for bench, space in spaces.items():
        mod.Tuner(space, _settings(mod)).tune(
            _objective, cache=cache.bound(bench), validate="off",
            pipeline="off")
    return cache


def _view(trials):
    return [(t.benchmark, t.fingerprint, t.key, t.strategy,
             t.result.score, t.result.pruned, t.result.stop_reason,
             [(i.mean, i.count, i.m2, i.stop_reason)
              for i in t.result.invocations])
            for t in trials]


def test_reference_reads_what_the_port_wrote(tmp_path):
    path = tmp_path / "port.jsonl"
    _tune_into(port, path)
    assert _view(ref.load_trials(path)) == _view(port.load_trials(path))
    again = ref.TrialCache(path, fingerprint=FP)
    assert len(again) == 6 and again.n_stale == 0


def test_port_reads_what_the_reference_wrote(tmp_path):
    path = tmp_path / "ref.jsonl"
    _tune_into(ref, path)
    assert _view(port.load_trials(path)) == _view(ref.load_trials(path))
    cache = port.TrialCache(path, fingerprint=FP)
    hit = cache.get("triad", {"n_bytes": 1 << 28},
                    settings_key=port.settings_key(_settings(port)))
    assert hit is not None and hit.score == pytest.approx(268.4, rel=0.01)
    # a resumed port session serves every config from the cache
    result = port.Tuner(port.grid(n_bytes=(1 << 22, 1 << 28)),
                        _settings(port)).tune(
        _objective, cache=cache.bound("triad"), validate="off")
    assert result.n_cached == 2


def test_both_packages_write_identical_bytes(tmp_path):
    for mod, name in ((port, "a"), (ref, "b")):
        _tune_into(mod, tmp_path / f"{name}.jsonl")
    ours = (tmp_path / "a.jsonl").read_text().splitlines()
    theirs = (tmp_path / "b.jsonl").read_text().splitlines()
    # wall-clock fields differ between runs; everything else must not
    strip = ("total_time_s", "measured_time_s", "elapsed_s")

    def canon(line):
        import json
        rec = json.loads(line)
        for key in strip:
            rec["result"].pop(key, None)
        for inv in rec["result"]["invocations"]:
            inv.pop("elapsed_s", None)
        return json.dumps(rec, sort_keys=True)

    assert [canon(x) for x in ours] == [canon(x) for x in theirs]
    assert port.CACHE_VERSION == ref.CACHE_VERSION


def test_one_record_round_trips_to_the_same_line(tmp_path):
    inv = dict(mean=1.25, count=7, elapsed_s=0.5, stop_reason="max_count(7)",
               pruned=False, m2=0.0625)
    lines = []
    for mod, name in ((port, "a"), (ref, "b")):
        res = mod.EvalResult(score=1.25, best_invocation=1.25,
                             invocations=(mod.InvocationResult(**inv),),
                             total_samples=7, total_time_s=0.75,
                             measured_time_s=0.5, pruned=False,
                             stop_reason="max_count(1)")
        cache = mod.TrialCache(tmp_path / f"{name}.jsonl", fingerprint=FP)
        cache.put("dgemm", {"n": 1, "m": 2, "k": 3}, res,
                  strategy="exhaustive", settings_key="abc")
        lines.append((tmp_path / f"{name}.jsonl").read_bytes())
    assert lines[0] == lines[1]


@pytest.mark.parametrize("overrides", [
    {}, {"use_ci_convergence": True}, {"max_iterations": 4},
    {"use_inner_prune": True, "use_outer_prune": True, "ci_method": "median"},
])
def test_settings_keys_agree(overrides):
    ours = dataclasses.replace(port.EvaluationSettings(), **overrides)
    theirs = dataclasses.replace(ref.EvaluationSettings(), **overrides)
    assert port.settings_key(ours) == ref.settings_key(theirs)
    assert ours.label() == theirs.label()


def test_config_keys_agree():
    cfg = {"n": 512, "k": 64, "m": 1024}
    assert port.config_key(cfg) == ref.config_key(cfg)


def test_both_render_the_same_dashboard(tmp_path):
    path = tmp_path / "mixed.jsonl"
    _tune_into(ref, path)
    _tune_into(ref, path, fingerprint="cpu:x86_64:torch-x")
    ref_reports, ref_skipped = ref.build_reports(ref.load_trials(path))
    our_reports, our_skipped = port.build_reports(port.load_trials(path))
    assert len(our_reports) == 2
    assert port_report.render_markdown(our_reports, our_skipped) == \
        ref_report.render_markdown(ref_reports, ref_skipped)
    assert port_report.render_csv(our_reports) == \
        ref_report.render_csv(ref_reports)
    assert port.dgemm_config_intensity({"n": 4000, "m": 2000, "k": 1024}) \
        == ref.dgemm_config_intensity({"n": 4000, "m": 2000, "k": 1024})


def test_fingerprint_is_lazy_and_names_the_device():
    fp = port.hardware_fingerprint("cpu")
    assert fp.startswith("cpu:") and ":torch-" in fp
    assert port.hardware_fingerprint("cpu") is fp
