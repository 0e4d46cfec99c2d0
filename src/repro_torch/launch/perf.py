"""§Perf hillclimbing driver (the JAX package's ``launch/perf.py``).

Re-runs one dry-run cell under explicit knob overrides (sharding rules,
remat policy, microbatches, loss chunk, ...) and prints the roofline-term
deltas vs the baseline — the measure step of the paper's
hypothesis -> change -> measure -> validate loop, with the dry run's
per-device trace on H100 terms as the measurement (estimates, not card
timings). Each cell is traced once at full depth (no 1-/2-unit
cross-check).

``--tune`` mode closes the loop with the paper's own machinery: the core
Tuner searches a small knob space using the dominant roofline term as
the (deterministic) objective.

  CUDA_VISIBLE_DEVICES="" PYTHONPATH=src python -m repro_torch.launch.perf \\
      --arch mamba2_130m --shape train_4k --tune
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Optional

from .. import configs
from ..core import Direction, EvaluationSettings, Tuner, grid
from ..models.config import SHAPES
from ..models.transformer import StepConfig
from .dryrun import run_cell

__all__ = ["DP_ONLY", "PRESETS", "main", "objective", "run_once", "show",
           "term", "tune_knobs"]


def term(record: dict, name: str) -> float:
    return record.get(f"{name}_ms", float("inf"))


def objective(record: dict) -> float:
    """Perfect-overlap step-time lower bound (max of the three terms)."""
    return max(record["compute_ms"], record["memory_ms"],
               record["collective_ms"])


def show(tag: str, r: dict) -> None:
    if r["status"] != "ok":
        print(f"[{tag}] {r['status']}: {r.get('error', '')}")
        return
    print(f"[{tag}] compute={r['compute_ms']}ms memory={r['memory_ms']}ms "
          f"collective={r['collective_ms']}ms -> {r['dominant']} "
          f"| useful={r['useful_flops_ratio']} mfu_bound={r['mfu_bound']} "
          f"peak={r['peak_gb']}GB")


# pure data parallelism over every mesh axis + ZeRO: the layout for
# sub-2B models (TP collectives vanish; only grad sync + FSDP gathers)
DP_ONLY = {"batch": ("pod", "data", "model"), "heads": (), "mlp": (),
           "vocab": (), "ssm_inner": (), "act_seq": ()}

PRESETS = {"dp-only": DP_ONLY}


def run_once(arch, shape, mesh, step_kw=None, rules_override=None,
             cfg_override=None, verbose=False):
    step_cfg = StepConfig(**step_kw) if step_kw else None
    return run_cell(arch, shape, mesh, step_cfg=step_cfg,
                    rules_override=rules_override,
                    cfg_override=cfg_override, verbose=verbose,
                    cross_check=False)


def tune_knobs(arch: str, shape: str, mesh: str, out_path: Optional[str]):
    """CI-machinery-driven knob search on the cost-model objective."""
    cfg = configs.get(arch)
    knobs = {"microbatches": (1, 2)}
    cfg_knobs = {}
    if cfg.family in ("ssm", "hybrid"):
        cfg_knobs["ssm_chunk"] = (128, 512)
    else:
        knobs["loss_chunk"] = (256, 1024)
    space = grid(**knobs, **cfg_knobs)
    settings = EvaluationSettings(max_invocations=1, max_iterations=1,
                                  direction=Direction.MINIMIZE,
                                  use_inner_prune=True)
    records = {}

    def benchmark(knob_cfg):
        step_kw = {k: v for k, v in knob_cfg.items() if k in knobs}
        cfg_kw = {k: v for k, v in knob_cfg.items() if k in cfg_knobs}

        def factory():
            def sample():
                r = run_once(arch, shape, mesh, step_kw=step_kw,
                             cfg_override=cfg_kw or None)
                records[tuple(sorted(knob_cfg.items()))] = r
                return objective(r) if r["status"] == "ok" else 1e12
            return sample
        return factory

    result = Tuner(space, settings).tune(benchmark)
    print(f"\n[tune] best knobs: {result.best_config} -> "
          f"{result.best_score:.1f}ms lower bound "
          f"({len(result.trials)} traces)")
    if out_path:
        with open(out_path, "a") as f:
            for k, r in records.items():
                f.write(json.dumps({"knobs": dict(k), **r}) + "\n")
    return result


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--loss-chunk", type=int, default=None)
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--grad-bf16", action="store_true")
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence-parallel activations")
    ap.add_argument("--preset", default=None, choices=list(PRESETS),
                    help="sharding-rule preset (e.g. dp-only)")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override, e.g. --set moe_group_size=128")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip tracing the baseline (chained variants)")
    args = ap.parse_args(argv)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    if args.tune:
        tune_knobs(args.arch, args.shape, args.mesh, args.out)
        return

    baseline = None
    if not args.no_baseline:
        baseline = run_once(args.arch, args.shape, args.mesh)
        show("baseline", baseline)
    step_kw = {}
    if args.microbatches is not None:
        step_kw["microbatches"] = args.microbatches
    if args.loss_chunk is not None:
        step_kw["loss_chunk"] = args.loss_chunk
    if args.remat_policy is not None:
        step_kw["remat_policy"] = args.remat_policy
    if args.grad_bf16:
        step_kw["grad_bf16"] = True
    rules_override = {"act_seq": ()} if args.no_sp else None
    if args.preset:
        rules_override = dict(PRESETS[args.preset])
    cfg_override = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        cfg_override[k] = int(v) if v.lstrip("-").isdigit() else v
    if step_kw or rules_override or cfg_override:
        varied = run_once(args.arch, args.shape, args.mesh,
                          step_kw=step_kw or None,
                          rules_override=rules_override,
                          cfg_override=cfg_override or None)
        show("variant ", varied)
        if baseline and varied["status"] == "ok" and baseline["status"] == "ok":
            print(f"[delta] lower bound {objective(baseline):.1f}ms -> "
                  f"{objective(varied):.1f}ms")
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps({"variant": {**step_kw, **cfg_override,
                                                "no_sp": args.no_sp,
                                                "preset": args.preset},
                                    **varied}) + "\n")


if __name__ == "__main__":
    main()
