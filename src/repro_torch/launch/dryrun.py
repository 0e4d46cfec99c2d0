"""Multi-pod dry run: trace every (arch × shape × mesh) cell's step on a
fake world (the JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each cell for 256 or 512 placeholder
host devices. The port builds the production mesh over a fake process
group of 256 or 512 ranks (:func:`repro_torch.launch.mesh.
make_production_mesh`; this process is rank 0, collectives do nothing)
and runs the step once on ``meta`` DTensors of the cell's full
configuration: nothing is allocated, sent or launched, and no card is
touched (it runs with ``CUDA_VISIBLE_DEVICES=""``). The trace
(:meth:`repro_torch.train.steps.StepBundle.lower`) gives rank 0's
per-device FLOPs, bytes, collectives and memory.

The reference needs two passes because XLA's ``cost_analysis`` counts a
scan body once: the full config for memory, then the model at 1 and 2
"layer units" with the scans unrolled, extrapolated linearly. Eager
counting has no such problem, so the port counts at full depth; with
analysis it also traces 1 and 2 units and records the extrapolation and
its relative difference from the full count
(``extrapolation_rel_err``), a cross-check that is 0 up to rounding on
shape-identical layers. The roofline terms are H100 estimates
(:mod:`repro_torch.analysis.terms`).

Records keep the reference's keys (``compile_s`` is the full trace's
seconds). Write them under ``build/``: the reference's
``results/dryrun*.jsonl`` are its own, and ``--out`` refuses a path in a
``results`` directory.

Usage:
  CUDA_VISIBLE_DEVICES="" PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch granite_3_2b --shape train_4k --mesh single
  CUDA_VISIBLE_DEVICES="" PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --all --mesh both --no-analysis --out build/dryrun_torch.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
import traceback
from typing import Optional

from .. import configs
from ..analysis.terms import RooflineTerms, model_flops
from ..distributed import sharding as sh
from ..models.config import SHAPES, ModelConfig, cell_is_applicable
from ..models.transformer import StepConfig
from ..train.steps import build_step, default_step_cfg
from .mesh import make_production_mesh

__all__ = ["MESHES", "layer_unit", "main", "run_cell", "scaled_config"]

MESHES = {"single": dict(multi_pod=False), "multi": dict(multi_pod=True)}


def layer_unit(cfg: ModelConfig) -> int:
    """Smallest layer count that preserves the arch's repeating structure."""
    if cfg.family == "vlm":
        return cfg.cross_attn_every
    if cfg.family == "hybrid" and cfg.attn_every:
        return cfg.attn_every
    return 1


def scaled_config(cfg: ModelConfig, units: int) -> ModelConfig:
    unit = layer_unit(cfg)
    changes = {"n_layers": unit * units}
    if cfg.family == "encdec":
        changes["n_enc_layers"] = units
    return dataclasses.replace(cfg, **changes)


def _trace(cfg, shape, mesh, rules, step_cfg):
    return build_step(cfg, shape, mesh, rules, step_cfg).lower()


def run_cell(arch: str, shape_name: str, mesh_name: str,
             step_cfg: Optional[StepConfig] = None,
             rules_override: Optional[dict] = None,
             cfg_override: Optional[dict] = None,
             analyze: bool = True, verbose: bool = True,
             cross_check: bool = True) -> dict:
    """Trace one cell; returns the record dict. ``cross_check=False``
    skips the 1-/2-unit extrapolation of an analyzed cell (its terms come
    from the full trace either way)."""
    cfg = configs.get(arch)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    shape = SHAPES[shape_name]
    if step_cfg is None:
        step_cfg = default_step_cfg(cfg, shape)
    if not cell_is_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "full-attention arch; long_500k requires "
                          "sub-quadratic attention (DESIGN.md §4)"}
    mesh = make_production_mesh(**MESHES[mesh_name])
    chips = mesh.size()
    rules = sh.TRAIN_RULES if shape.kind == "train" else sh.SERVE_RULES
    if rules_override:
        rules = rules.replace(**rules_override)
    t0 = time.perf_counter()
    try:
        full = _trace(cfg, shape, mesh, rules, step_cfg)
        t_full = time.perf_counter() - t0
        record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "status": "ok", "chips": chips,
                  "compile_s": round(t_full, 1),
                  "args_gb": round(full.args_bytes / 1e9, 3),
                  "temp_gb": round(full.temp_bytes / 1e9, 3),
                  "out_gb": round(full.out_bytes / 1e9, 3),
                  "peak_gb": round(full.peak_bytes / 1e9, 3)}
        if analyze:
            terms = RooflineTerms(
                arch=cfg.name, shape=shape_name, mesh=mesh_name,
                flops_per_dev=full.flops, bytes_per_dev=full.bytes_accessed,
                coll_bytes_per_dev=full.collectives.total_bytes,
                coll_summary=full.collectives.summary(),
                peak_bytes_per_dev=full.peak_bytes,
                model_flops_total=model_flops(cfg, shape), chips=chips)
            record.update(terms.row())
            record.update({
                "flops_per_dev": full.flops,
                "bytes_per_dev": full.bytes_accessed,
                "coll_bytes_per_dev": full.collectives.total_bytes,
                "model_flops_total": terms.model_flops_total,
                "args_bytes_per_dev": full.args_bytes,
            })
            if cross_check:
                unit = layer_unit(cfg)
                total_units = cfg.n_layers // unit
                # a depth of 1 or 2 units is the full trace itself
                c1, c2 = (full if scaled_config(cfg, k) == cfg else
                          _trace(scaled_config(cfg, k), shape, mesh, rules,
                                 step_cfg) for k in (1, 2))
                extrap = c1.flops + (c2.flops - c1.flops) * (total_units - 1)
                record.update({
                    "extrapolated_flops_per_dev": extrap,
                    "extrapolation_rel_err": abs(extrap - full.flops)
                    / max(full.flops, 1.0)})
            if verbose:
                print(f"[{arch} × {shape_name} × {mesh_name}] OK "
                      f"trace={t_full:.0f}s peak={record['peak_gb']}GB/dev")
                print(f"  roofline (H100 estimates): "
                      f"compute={terms.compute_s*1e3:.2f}ms "
                      f"memory={terms.memory_s*1e3:.2f}ms "
                      f"collective={terms.collective_s*1e3:.2f}ms "
                      f"-> {terms.dominant}-bound "
                      f"useful={terms.useful_flops_ratio:.2f} "
                      f"mfu_bound={terms.mfu_bound:.3f}")
                print(f"  collectives: {terms.coll_summary}")
                if cross_check:
                    print(f"  1-/2-unit extrapolation: rel. difference "
                          f"{record['extrapolation_rel_err']:.2e}")
        elif verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] OK "
                  f"trace={t_full:.0f}s peak={record['peak_gb']}GB/dev")
        return record
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] FAIL: {e}")
            traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "error", "error": f"{type(e).__name__}: {e}"}


def _check_out(path: str) -> str:
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    if "results" in parts[:-1]:
        raise SystemExit(f"--out {path}: the dry run's records go under "
                         f"build/, not into a results directory")
    return path


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", default=None,
                    help="arch id(s); default: all")
    ap.add_argument("--shape", action="append", default=None,
                    choices=list(SHAPES), help="shape(s); default: all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-analysis", action="store_true",
                    help="full trace only (no roofline terms and no "
                         "extrapolation cross-check)")
    ap.add_argument("--out", default=None,
                    help="append JSONL records here (under build/)")
    args = ap.parse_args(argv)
    # DTensor warns that a CPU mesh carries out an all-to-all as an
    # all-gather (the trace counts the all-to-all it plans) and that a
    # reduction over two mesh dims takes two all-reduces (counted so)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    out = _check_out(args.out) if args.out else None
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)

    archs = args.arch or configs.ARCH_IDS
    shapes = args.shape or list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_ok = n_fail = n_skip = 0
    t0 = time.perf_counter()
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                rec = run_cell(arch, shape_name, mesh_name,
                               analyze=not args.no_analysis)
                if out:
                    with open(out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                n_ok += rec["status"] == "ok"
                n_fail += rec["status"] == "error"
                n_skip += rec["status"] == "skipped"
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"in {time.perf_counter() - t0:.0f}s")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
