"""The dry run and its analysis against the JAX package's: the model
FLOPs of all 40 (arch, shape) pairs, the roofline terms, the report
tables and the finalize CLI on the same records, the distributed tuner
on a deterministic benchmark; and the port's own per-device trace on a
fake (16, 16) world: local (not global) FLOPs, the reference's
collective traffic formula, one dry-run cell in a process of its own,
and ``launch.perf``.

Tolerances: the model FLOPs and the terms are the same arithmetic on the
same numbers (rtol 1e-12); the tables are compared as text; the tuner's
best config, samples and pruned count exactly and its merged (n, mean,
M2) to rtol 1e-12; the traced MLP's per-device FLOPs and bytes exactly
(integer counts); the full-depth count against the 1-/2-unit
extrapolation to 1e-6 relative."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import repro.configs as jax_configs
from repro.analysis.terms import RooflineTerms as JaxTerms
from repro.analysis.terms import model_flops as jax_model_flops
from repro.core import roofline as jax_roofline
from repro.launch import report as jax_report
from repro.models.config import SHAPES as JAX_SHAPES
from repro_torch import configs, finalize_experiments
from repro_torch.analysis.terms import RooflineTerms, model_flops
from repro_torch.analysis.trace import collective_traffic, trace_call
from repro_torch.core.roofline import H100_SXM
from repro_torch.launch import report
from repro_torch.launch.mesh import make_production_mesh, release_world
from repro_torch.models.config import SHAPES

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_equal_the_references(arch, shape):
    got = model_flops(configs.get(arch), SHAPES[shape])
    want = jax_model_flops(jax_configs.get(arch), JAX_SHAPES[shape])
    assert got == pytest.approx(want, rel=1e-12)


def test_roofline_terms_equal_the_references_class():
    numbers = dict(arch="a", shape="s", mesh="single", flops_per_dev=3.1e14,
                   bytes_per_dev=2.2e11, coll_bytes_per_dev=4.4e10,
                   coll_summary="all-reduce:3x/1.0MB",
                   peak_bytes_per_dev=7.5e9, model_flops_total=5.0e16,
                   chips=256)
    machine = jax_roofline.MachineSpec(
        name=H100_SXM.name, peak_flops=H100_SXM.peak_flops,
        mem_bandwidths=dict(H100_SXM.mem_bandwidths),
        link_bandwidth=H100_SXM.link_bandwidth)
    got = RooflineTerms(**numbers)
    want = JaxTerms(**numbers, machine=machine)
    for prop in ("compute_s", "memory_s", "collective_s",
                 "step_time_lower_bound_s", "useful_flops_ratio",
                 "mfu_bound"):
        assert getattr(got, prop) == pytest.approx(getattr(want, prop),
                                                   rel=1e-12), prop
    assert got.dominant == want.dominant and got.row() == want.row()


def _records():
    base = {"status": "ok", "chips": 256, "compile_s": 12.5,
            "args_gb": 0.5, "temp_gb": 2.0, "out_gb": 0.1, "peak_gb": 2.6,
            "compute_ms": 100.0, "memory_ms": 20.0, "collective_ms": 3.0,
            "dominant": "compute", "useful_flops_ratio": 0.8,
            "mfu_bound": 0.5, "collectives": "all-reduce:2x/1.0MB"}
    recs = [{**base, "arch": "granite_3_2b", "shape": "train_4k",
             "mesh": "single"},
            {**base, "arch": "zamba2-2.7b", "shape": "decode_32k",
             "mesh": "multi", "peak_gb": 40.0, "args_gb": 30.0},
            {**base, "arch": "mixtral_8x22b", "shape": "prefill_32k",
             "mesh": "single", "peak_gb": 15.0, "args_gb": 0.5},
            {"arch": "gemma_2b", "shape": "long_500k", "mesh": "single",
             "status": "skipped", "reason": "x"},
            {"arch": "gemma_2b", "shape": "train_4k", "mesh": "multi",
             "status": "error", "error": "RuntimeError: y"}]
    return recs


def _no_fit(table: str) -> list[str]:
    """The table with its last (fit) column dropped."""
    return [row.rsplit("|", 2)[0] for row in table.splitlines()]


def test_report_tables_equal_the_references(tmp_path):
    path = tmp_path / "r.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    got, want = report.load([str(path)]), jax_report.load([str(path)])
    assert got == want
    assert report.summary(got) == jax_report.summary(want)
    for mesh in ("single", "multi"):
        assert report.roofline_table(got, mesh) == \
            jax_report.roofline_table(want, mesh)
    assert _no_fit(report.dryrun_table(got)) == \
        _no_fit(jax_report.dryrun_table(want))
    # the fit column holds the H100's 80 GB (the reference: v5e's 16 GB),
    # on the reference's peak_gb + args_gb
    def fits(table):
        return {tuple(c.strip() for c in row.split("|")[1:4]):
                row.rsplit("|", 2)[1].strip()
                for row in table.splitlines()[2:]}

    mine, ref = fits(report.dryrun_table(got)), fits(
        jax_report.dryrun_table(want))
    cell = ("zamba2-2.7b", "decode_32k", "multi")    # 40 + 30 GB
    assert mine[cell] == "yes" and ref[cell] == "**no**"
    assert mine[("gemma-2b", "long_500k", "single")] == "-"
    assert mine[("gemma-2b", "train_4k", "multi")] == "**no**"


def test_finalize_cli_matches_the_reference_script(tmp_path):
    recs = tmp_path / "r.jsonl"
    recs.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    doc = tmp_path / "EXP.md"
    doc.write_text("a\n<!-- DRYRUN_TABLE -->\nb\n<!-- ROOFLINE_TABLE -->\n")
    script = REPO / "scripts" / "finalize_experiments.py"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    for argv, code in (([str(recs)], 0), (["--check"], 0), ([], 2),
                       ([str(tmp_path / "missing.jsonl")], 2)):
        ref = subprocess.run([sys.executable, str(script), *argv, "--file",
                              str(doc)], capture_output=True, text=True,
                             env=env, timeout=120)
        assert ref.returncode == code
        assert finalize_experiments.main([*argv, "--file", str(doc)]) == code
    bare = tmp_path / "bare.md"
    bare.write_text("no markers\n")
    assert finalize_experiments.main(["--check", "--file", str(bare)]) == 1
    assert finalize_experiments.main(["--file", str(tmp_path / "x.md")]) == 2
    text = finalize_experiments.finalize(doc.read_text(),
                                         report.load([str(recs)]))
    assert "#### Multi-pod (512 chips)" in text
    assert "cells: 3 ok, 1 skipped (documented), 1 failed" in text


@pytest.fixture
def fake_world():
    release_world()
    yield make_production_mesh()
    release_world()


def test_fake_world_mlp_counts_per_device_flops_and_traffic(fake_world):
    """(64, 4096, 2048)·(2048, 8192)·(8192, 2048) on the (16, 16) world,
    batch over ``data``, the hidden dim over ``model``: 68.7 GFLOP a
    device (the global count is 256 times that), and the second
    product's all-reduce over ``model`` moves 2·size·15/16 bytes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models.dots import einsum
    mesh = fake_world

    def meta(*shape, pl):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh, pl,
                                 src_data_rank=None)

    x = meta(64, 4096, 2048, pl=[Shard(0), Replicate()])
    w1 = meta(2048, 8192, pl=[Replicate(), Shard(1)])
    w2 = meta(8192, 2048, pl=[Replicate(), Shard(0)])

    def mlp(x, w1, w2):
        y = einsum("bsf,fd->bsd", einsum("bsd,df->bsf", x, w1), w2)
        return y.redistribute(mesh, [Shard(0), Replicate()])

    tr = trace_call(mlp, (x, w1, w2))
    assert tr.flops == 2 * 2 * 64 * 4096 * 2048 * 8192 / 256
    assert tr.flops == pytest.approx(68.7e9, rel=1e-3)
    out_bytes = 64 * 4096 * 2048 * 4 / 16
    assert tr.collectives.count_by_op == {"all-reduce": 1}
    assert tr.collectives.bytes_by_op["all-reduce"] == \
        2 * out_bytes * 15 / 16
    assert collective_traffic("all-gather", 16.0, 16) == 15.0
    assert collective_traffic("reduce-scatter", 16.0, 16) == 240.0
    assert tr.args_bytes == (64 * 4096 * 2048 / 16 + 2 * 2048 * 8192 / 16) * 4


def test_dry_run_cell_in_its_own_process():
    """One cell, 2 layers, in a subprocess that sees no card: under 30 s,
    ok, finite terms; and at 3 layers (three distinct traces: 3, 1 and 2
    layers) the full-depth count equal to the 1-/2-unit extrapolation
    (shape-identical layers)."""
    code = """
import json, sys, time
from repro_torch.launch.dryrun import run_cell
t0 = time.perf_counter()
rec = run_cell("granite_3_2b", "train_4k", "single",
               cfg_override={"n_layers": 2}, verbose=False)
rec["wall_s"] = time.perf_counter() - t0
rec["rel_3"] = run_cell("granite_3_2b", "train_4k", "single",
                        cfg_override={"n_layers": 3},
                        verbose=False)["extrapolation_rel_err"]
print(json.dumps(rec))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["wall_s"] < 30
    assert rec["extrapolation_rel_err"] <= 1e-6 and rec["rel_3"] <= 1e-6
    for key in ("compute_ms", "memory_ms", "collective_ms"):
        assert 0 < rec[key] < float("inf")
    cfg = dataclasses.replace(configs.get("granite_3_2b"), n_layers=2)
    assert rec["model_flops_total"] == 6 * cfg.n_active_params() \
        * SHAPES["train_4k"].tokens


def test_perf_driver_prints_baseline_variant_and_delta(fake_world, capsys):
    from repro_torch.launch import perf
    assert perf.PRESETS == {"dp-only": perf.DP_ONLY}
    perf.main(["--arch", "mamba2_130m", "--shape", "decode_32k",
               "--set", "n_layers=1", "--remat-policy", "dots_saveable",
               "--preset", "dp-only"])
    out = capsys.readouterr().out
    assert "[baseline] compute=" in out and "[variant ] compute=" in out
    assert "[delta] lower bound" in out


def _deterministic(cfg):
    score = cfg["n"] * cfg["m"] * cfg["k"] / 1e7
    invocation = iter(range(10 ** 6))

    def factory():
        inv = next(invocation)
        ticks = iter(range(10 ** 6))
        return lambda: score * (1.0 + 0.01 * ((next(ticks) + inv) % 5 - 2))

    return factory


def test_distributed_tuner_equals_the_references():
    from repro.core import EvaluationSettings as JaxSettings
    from repro.core import Direction as JaxDirection
    from repro.core import grid as jax_grid
    from repro.distributed.tuner import DistributedTuner as JaxTuner
    from repro.distributed.tuner import replicated_evaluate as jax_replicated
    from repro_torch.core import Direction, EvaluationSettings, grid
    from repro_torch.distributed import (DistributedTuner,
                                         replicated_evaluate)
    dims = dict(n=(64, 128, 256), m=(64, 128), k=(32, 64))
    kw = dict(max_invocations=3, max_iterations=20, use_ci_convergence=True,
              use_inner_prune=True, use_outer_prune=True)
    got = DistributedTuner(grid(**dims), EvaluationSettings(
        direction=Direction.MAXIMIZE, **kw), n_workers=4).tune(
            _deterministic)
    want = JaxTuner(jax_grid(**dims), JaxSettings(
        direction=JaxDirection.MAXIMIZE, **kw), n_workers=4).tune(
            _deterministic)
    assert got.best_config == want.best_config
    assert got.total_samples == want.total_samples
    assert got.n_pruned == want.n_pruned and got.n_workers == 4
    assert [t.config for t in got.trials] == [t.config for t in want.trials]
    settings = EvaluationSettings(max_invocations=3, max_iterations=10)
    ci, merged, _ = replicated_evaluate(_deterministic({"n": 64, "m": 64,
                                                        "k": 64}),
                                        settings, n_workers=3)
    jci, jmerged, _ = jax_replicated(_deterministic({"n": 64, "m": 64,
                                                     "k": 64}),
                                     JaxSettings(max_invocations=3,
                                                 max_iterations=10),
                                     n_workers=3)
    assert merged.count == jmerged.count
    assert merged.mean == pytest.approx(jmerged.mean, rel=1e-12)
    assert merged.m2 == pytest.approx(jmerged.m2, rel=1e-12)
    assert (ci.lo, ci.hi) == pytest.approx((jci.lo, jci.hi), rel=1e-12)
