"""The port's paper-table benches against ``benchmarks/bench_*.py``: each
``run()`` on the host over a monkeypatched two-config space with a
one-invocation budget gives the same table columns, technique labels,
CSV row names and evaluation settings (scores are timings and are not
compared). Also: the DGEMM factory's steady sampler and per-config
operands, ``bench.run`` end to end, the roofline report byte for byte
against ``scripts/roofline_report.py``, and the harness's ``--check``."""

import importlib.util
import itertools
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import benchmarks.common as ref_common
import repro.core as ref
import repro.core.evaluator as ref_evaluator
import repro_torch.core as port
import repro_torch.core.evaluator as port_evaluator
from benchmarks import (bench_iteration_counts, bench_kernel_autotune,
                        bench_matmul_peak, bench_optimizations,
                        bench_size_sweep, bench_triad)
from repro_torch.bench import (common, harness, iteration_counts,
                               kernel_autotune, matmul_peak, optimizations,
                               size_sweep, triad)
from repro_torch.bench import run as bench_run
from repro_torch.kernels.matmul import BF16_TILES

REPO = pathlib.Path(__file__).resolve().parent.parent
TWO = {"n": (32, 48), "m": (40,), "k": (16,)}


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _budget(mod):
    return mod.EvaluationSettings(max_invocations=1, max_iterations=4,
                                  max_time_s=0.5,
                                  direction=mod.Direction.MAXIMIZE)


def _instrument(monkeypatch, bench_mod, core, csv_rows):
    """Capture a bench module's tables, CSV names and the settings every
    Tuner/Evaluator it builds runs under."""
    seen = {"tables": [], "settings": []}
    monkeypatch.setattr(bench_mod, "print_table",
                        lambda title, rows: seen["tables"].append(
                            [dict(r) for r in rows]))
    monkeypatch.setattr(bench_mod, "paper_settings",
                        lambda quick=True: _budget(core), raising=False)

    class Tuner(core.Tuner):
        def __init__(self, space, settings, *a, **kw):
            seen["settings"].append(("tuner", core.settings_key(settings),
                                     kw.get("order", "exhaustive")))
            super().__init__(space, settings, *a, **kw)

    class Evaluator(core.Evaluator):
        def __init__(self, settings, *a, **kw):
            seen["settings"].append(("evaluator",
                                     core.settings_key(settings)))
            super().__init__(settings, *a, **kw)

    for name, cls in (("Tuner", Tuner), ("Evaluator", Evaluator)):
        if hasattr(bench_mod, name):
            monkeypatch.setattr(bench_mod, name, cls)
    csv_rows.clear()
    return seen


def _run_pair(monkeypatch, ref_mod, port_mod, **patches):
    theirs = _instrument(monkeypatch, ref_mod, ref, ref_common.CSV_ROWS)
    ours_seen = None
    for attr, (ref_value, port_value) in patches.items():
        if hasattr(ref_mod, attr):
            monkeypatch.setattr(ref_mod, attr, ref_value)
    monkeypatch.setattr(ref_mod, "dgemm_space",
                        lambda quick=True: ref.grid(**TWO), raising=False)
    ref_out = ref_mod.run(quick=True)
    theirs["csv"] = [row[0] for row in ref_common.CSV_ROWS]
    theirs["derived"] = [row[2] for row in ref_common.CSV_ROWS]

    ours_seen = _instrument(monkeypatch, port_mod, port, common.CSV_ROWS)
    for attr, (ref_value, port_value) in patches.items():
        monkeypatch.setattr(port_mod, attr, port_value)
    monkeypatch.setattr(port_mod, "paper_dgemm_space",
                        lambda quick=True, device="cuda": port.grid(**TWO),
                        raising=False)
    port_out = port_mod.run(quick=True, device="cpu")
    ours_seen["csv"] = [row[0] for row in common.CSV_ROWS]
    ours_seen["derived"] = [row[2] for row in common.CSV_ROWS]
    return ours_seen, theirs, port_out, ref_out


def _columns(tables):
    return [[list(row) for row in rows] for rows in tables]


def _labels(tables, *cols):
    return [[tuple(row[c] for c in cols) for row in rows] for rows in tables]


@pytest.mark.parametrize("name", ["matmul_peak", "iteration_counts",
                                  "optimizations"])
def test_dgemm_tables_match_the_reference(monkeypatch, name):
    ref_mod = {"matmul_peak": bench_matmul_peak,
               "iteration_counts": bench_iteration_counts,
               "optimizations": bench_optimizations}[name]
    port_mod = {"matmul_peak": matmul_peak,
                "iteration_counts": iteration_counts,
                "optimizations": optimizations}[name]
    ours, theirs, _, _ = _run_pair(monkeypatch, ref_mod, port_mod)
    label = "config" if name == "matmul_peak" else "technique"
    assert _columns(ours["tables"]) == _columns(theirs["tables"])
    assert _labels(ours["tables"], label) == _labels(theirs["tables"], label)
    assert ours["csv"] == theirs["csv"]
    assert [d.split("=")[0] for d in ours["derived"]] == \
        [d.split("=")[0] for d in theirs["derived"]]
    assert ours["settings"] == theirs["settings"]


def test_optimizations_covers_every_technique_row(monkeypatch):
    ours, _, rows, _ = _run_pair(monkeypatch, bench_optimizations,
                                 optimizations)
    base = common.paper_settings(True)
    want = list(port.standard_techniques(base)) + [
        "C+I+O (median)", "Hand-tuned Time", "Hand-tuned Accuracy"]
    assert [r["technique"] for r in rows] == want
    assert rows[0]["speedup"] == "1.00x" and rows[0]["err_raw"] == "0.00%"
    assert {r["err_refined"] for r in rows[-2:]} == {"-"}
    ref_keys = [ref.settings_key(s) for s, _ in
                ref.standard_techniques(ref_common.paper_settings(True))
                .values()]
    assert [port.settings_key(s) for s, _ in
            list(optimizations.techniques(base).values())[:-1]] == ref_keys


def test_triad_table_matches_the_reference(monkeypatch):
    sizes = [1 << 14, 1 << 16]
    ours, theirs, rows, _ = _run_pair(monkeypatch, bench_triad, triad,
                                      SIZES=(sizes, sizes))
    assert _columns(ours["tables"]) == _columns(theirs["tables"])
    assert _labels(ours["tables"], "working_set", "regime") == \
        _labels(theirs["tables"], "working_set", "regime") == \
        [[("16KiB", "cache"), ("64KiB", "cache")]]
    assert ours["csv"] == theirs["csv"] == ["triad/16KiB", "triad/64KiB"]
    assert ours["settings"] == theirs["settings"]
    assert all(r["gbytes_per_s"] > 0 for r in rows)


def test_size_sweep_matches_the_reference(monkeypatch):
    sizes = [32, 64]
    ours, theirs, rows, _ = _run_pair(monkeypatch, bench_size_sweep,
                                      size_sweep, SIZES=(sizes, sizes))
    assert _columns(ours["tables"]) == _columns(theirs["tables"])
    assert _labels(ours["tables"], "n=m=k") == \
        _labels(theirs["tables"], "n=m=k") == [[(32,), (64,)]]
    assert ours["csv"] == theirs["csv"] == ["size_sweep/n32", "size_sweep/n64"]
    assert ours["settings"] == theirs["settings"]


def test_kernel_autotune_matches_the_reference(monkeypatch):
    monkeypatch.setattr(common, "GEMM_TILED_SHAPE",
                        {"m": 64, "n": 48, "k": 40})
    ours, theirs, out, _ = _run_pair(monkeypatch, bench_kernel_autotune,
                                     kernel_autotune)
    # the f32 session's rows are the reference's; the bf16 session's
    # follow under their own names, with the same columns
    n_ref = len(theirs["tables"][0])
    assert _columns([t[:n_ref] for t in ours["tables"]]) == \
        _columns(theirs["tables"])
    table = ours["tables"][0]
    assert len(ours["tables"]) == 1 and len(table) == 2 * n_ref
    assert [list(r) for r in table[n_ref:]] == \
        [list(r) for r in table[:n_ref]]
    assert [r["quantity"] for r in table[n_ref:]] == \
        ["bf16 " + r["quantity"] for r in table[:n_ref]]
    assert _labels(ours["tables"], "quantity")[0][:2] == \
        _labels(theirs["tables"], "quantity")[0][:2]
    assert ours["csv"] == theirs["csv"] == ["kernel_autotune/best_tile"]
    keys = [[kv.split("=")[0] for kv in d.split(";")]
            for d in ours["derived"]]
    assert keys == [[kv.split("=")[0] for kv in d.split(";")]
                    for d in theirs["derived"]] == [["bm", "bn", "bk", "err"]]
    # two sessions (f32, then bf16), each under the reference's settings
    assert ours["settings"] == theirs["settings"] * 2
    assert out["trials"] == 12 and out["err"] == 0.0   # host: matmul_ref
    assert out["shape"] == {"m": 64, "n": 48, "k": 40}
    bf16 = out["bf16"]
    assert bf16["trials"] == len(BF16_TILES) and bf16["err"] == 0.0
    assert tuple(bf16["best"][d] for d in ("bm", "bn", "bk")) in BF16_TILES
    assert bf16["launches"] == {"cuda_cores": 0, "tensor_cores": 0}


def test_card_space_and_host_space():
    assert list(common.paper_dgemm_space(True, "cpu").configs()) == \
        list(ref_common.dgemm_space(True).configs())
    assert list(common.paper_dgemm_space(False, "cpu").configs()) == \
        list(ref_common.dgemm_space(False).configs())
    card = common.card_dgemm_space()
    full = list(common.dgemm_space(False).configs())
    assert card.cardinality == 8
    assert all(c in full for c in card.configs())
    gflop = sorted(common.dgemm_flops(c["n"], c["m"], c["k"]) / 1e9
                   for c in card.configs())
    assert gflop[0] == pytest.approx(8.192) and gflop[-1] == \
        pytest.approx(65.536)


def _counting(monkeypatch, module, attr, log):
    real = getattr(module, attr)

    def spy(*a, **kw):
        log.append(a[3] if attr.endswith("data") else 1)
        return real(*a, **kw)

    monkeypatch.setattr(module, attr, spy)
    return real


@pytest.mark.parametrize("reuse", [True, False])
def test_steady_factory_draws_once_and_calibrates_once(monkeypatch, reuse):
    n, m, k = 64, 48, 32
    ours_draws, ours_cal, ref_draws, ref_cal = [], [], [], []
    real = _counting(monkeypatch, common, "dgemm_data", ours_draws)
    _counting(monkeypatch, port_evaluator, "calibrate_batch", ours_cal)
    ref_real = _counting(monkeypatch, ref_common, "_dgemm_data", ref_draws)
    _counting(monkeypatch, ref_evaluator, "calibrate_batch", ref_cal)
    ours = common.dgemm_invocation_factory(n, m, k, device="cpu",
                                           sampler="steady",
                                           reuse_data=reuse)
    theirs = ref_common.dgemm_invocation_factory(n, m, k, sampler="steady",
                                                 reuse_data=reuse)
    samplers = [ours() for _ in range(3)]
    for _ in range(3):
        theirs()
    seeds = [common.dgemm_seed(n, m, k, i) for i in range(3)]
    assert ours_draws == ref_draws == (seeds[:1] if reuse else seeds)
    assert len(ours_cal) == len(ref_cal) == 1       # B cached per config
    assert len({s.batch for s in samplers}) == 1
    assert all(s() > 0 for s in samplers)
    a, b = real(n, m, k, seeds[0], device="cpu")
    ra, rb = ref_real(n, m, k, seeds[0], jnp.float32)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb))


def test_timed_factory_draws_every_invocation(monkeypatch):
    draws = []
    _counting(monkeypatch, common, "dgemm_data", draws)
    factory = common.dgemm_invocation_factory(16, 16, 8, device="cpu")
    for _ in range(3):
        assert factory()() > 0
    assert draws == [common.dgemm_seed(16, 16, 8, i) for i in range(3)]


def test_bench_run_triad_on_the_host_end_to_end(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "--only", "triad",
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    names = [ln.split(",")[0] for ln in lines if ln.startswith("triad/")]
    assert names == ["triad/256KiB", "triad/1024KiB", "triad/4096KiB",
                     "triad/16384KiB", "triad/65536KiB", "triad/total"]
    assert lines[-1].endswith(",ok") or "peak DRAM-stream" in proc.stdout
    assert "## Table VI analog: TRIAD bandwidth (this host)" in proc.stdout


def test_bench_run_keys_and_unported_entries(tmp_path, monkeypatch,
                                             capsys):
    import benchmarks.run as ref_run
    assert list(bench_run.BENCHES) == list(ref_run.BENCHES)
    # every bench is ported now, distributed_tuner included
    from repro_torch.bench import distributed_tuner
    assert bench_run.BENCHES["distributed_tuner"] is distributed_tuner.run
    with pytest.raises(RuntimeError, match="is_available"):
        bench_run.main(["--only", "triad"])
    # --html now writes the dashboard from the --resume cache dir
    monkeypatch.setitem(bench_run.BENCHES, "triad", lambda **_: None)
    out = tmp_path / "x.html"
    assert bench_run.main(["--only", "triad", "--device", "cpu", "--resume",
                           str(tmp_path), "--html", str(out)]) == 0
    assert f"[report] wrote {out}" in capsys.readouterr().out
    html = out.read_text(encoding="utf-8")
    assert html.startswith("<!DOCTYPE html>")
    assert "<title>Benchmark dashboard</title>" in html


def _deterministic(cfg):
    score = (cfg["n_bytes"] / 1e6 if "n_bytes" in cfg
             else cfg["n"] * cfg["m"] * cfg["k"] / 1e7)
    invocation = itertools.count()

    def factory():
        inv = next(invocation)
        ticks = itertools.count()
        return lambda: score * (1.0 + 0.01 * ((next(ticks) + inv) % 5 - 2))

    return factory


@pytest.mark.parametrize("confidence", [None, "0.95"])
def test_roofline_report_is_the_reference_byte_for_byte(tmp_path,
                                                        monkeypatch,
                                                        confidence):
    from repro_torch import roofline_report
    settings = port.EvaluationSettings(max_invocations=3, max_iterations=12,
                                       max_time_s=1e6,
                                       use_ci_convergence=True)
    spaces = {"dgemm": port.grid(n=(256, 512), m=(256,), k=(64, 128)),
              "triad": port.grid(n_bytes=(1 << 22, 1 << 28))}
    for bench, space in spaces.items():
        port.TuningSession("report", port.Tuner(space, settings),
                           _deterministic, cache_dir=tmp_path,
                           fingerprint="cuda:NVIDIA H100 80GB HBM3:sm90:n1",
                           benchmark_name=bench).run()
    cache = str(tmp_path / "report.jsonl")
    extra = ["--confidence", confidence] if confidence else []
    ref_script = _load_script("roofline_report")
    monkeypatch.setattr(sys, "argv", ["roofline_report.py", cache, *extra,
                                      "--out", str(tmp_path / "ref.md"),
                                      "--csv", str(tmp_path / "ref.csv")])
    assert ref_script.main() == 0
    assert roofline_report.main([cache, *extra,
                                 "--out", str(tmp_path / "ours.md"),
                                 "--csv", str(tmp_path / "ours.csv")]) == 0
    for ext in ("md", "csv"):
        ours = (tmp_path / f"ours.{ext}").read_bytes()
        assert ours == (tmp_path / f"ref.{ext}").read_bytes()
    assert b"peak compute F_p (dgemm)" in (tmp_path / "ours.md").read_bytes()
    # --html is ported: the dashboard carries the same roofline section
    assert roofline_report.main([cache, *extra, "--out", str(tmp_path / "x"),
                                 "--html", str(tmp_path / "x.html")]) == 0
    assert "Roofline — <code>cuda:NVIDIA H100 80GB HBM3:sm90:n1</code>" in \
        (tmp_path / "x.html").read_text(encoding="utf-8")
    # --attribute is ported: the tiny train step on the host, attributed
    # statically against the roofs recovered from this cache
    assert roofline_report.main([cache, *extra, "--attribute", "train_step",
                                 "--device", "cpu", "--out",
                                 str(tmp_path / "attr.md")]) == 0
    attributed = (tmp_path / "attr.md").read_text(encoding="utf-8")
    assert attributed.startswith((tmp_path / "ours.md").read_text(
        encoding="utf-8"))
    assert "## Roofline attribution: `train_step` (static)" in attributed


def _harness_doc(speedup=4.0, rel=0.01, ok=True) -> dict:
    fam = {"legacy": {"non_measured_per_trial_s": 0.02},
           "fast": {"non_measured_per_trial_s": 0.005},
           "speedup_non_measured": speedup}
    return {"bench_version": 2,
            "families": {"synthetic": fam, "dgemm": dict(fam)},
            "agreement": {"rel_diff": rel},
            "checks": {"pass": ok}}


@pytest.mark.parametrize("doc,code", [
    (_harness_doc(), 0),
    (_harness_doc(speedup=2.0, ok=False), 1),
    (_harness_doc(rel=0.05, ok=False), 1),
    ({"bench_version": 1}, 1),
])
def test_harness_check_agrees_with_the_reference(tmp_path, doc, code):
    path = tmp_path / "h.json"
    path.write_text(json.dumps(doc), encoding="utf-8")
    ref_harness = _load_script("bench_harness")
    assert harness.main(["--check", "--out", str(path)]) == code
    assert ref_harness.check(path) == code
    assert harness.main(["--check", "--out", str(tmp_path / "none")]) == 2


def test_harness_accounting_on_the_host():
    settings = port.EvaluationSettings(max_invocations=2, max_iterations=3,
                                       max_time_s=60.0,
                                       direction=port.Direction.MAXIMIZE)
    fam = harness._run_family({"n": 16, "m": 16}, {"base": 8, "step": 4},
                              4, settings, 1, "cpu")
    for mode in ("legacy", "fast"):
        run = fam[mode]
        assert run["trials"] == harness._CONFIGS_PER_SESSION
        assert run["non_measured_s"] == pytest.approx(
            max(run["wall_s"] - run["measured_s"], 0.0), abs=2e-6)
    assert fam["fast"]["n_precompiled"] > 0
    assert fam["legacy"]["n_precompiled"] == 0
    assert "sync" in fam["fast"]["phases"]
    agr = harness.sampler_agreement("cpu", n=64, obs=2, batch=2)
    assert agr["workload"] == "dgemm[64x64x64]" and agr["rel_diff"] >= 0
