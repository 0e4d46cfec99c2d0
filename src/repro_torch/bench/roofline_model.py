"""Fig. 1 analog: assemble the card's empirical Roofline model from the
autotuned peaks — the paper's end product (no vendor specs needed).

Rendering goes through :mod:`repro_torch.core.report`, so this bench
produces the same dashboard ``python -m repro_torch.tune --report``
emits. With ``cache_dir`` set, both tuning runs persist as the
``roofline`` session (benchmarks ``dgemm`` and ``triad``), and a rerun
resumes without re-measuring.

    python -m repro_torch.bench.roofline_model --cache-dir DIR [--full]
"""

from __future__ import annotations

import argparse
import dataclasses

from ..core import (TRIAD_INTENSITY, RandomSearchStrategy, Tuner,
                    TuningSession, build_reports, grid,
                    hardware_fingerprint, load_trials,
                    operational_intensity, render_markdown, ridge_point,
                    trials_from_result)
from ..device import resolve_device
from .common import (dgemm_benchmark, dgemm_space, emit, paper_settings,
                     print_table, triad_benchmark)

#: working sets well inside (4 MiB) and far outside (256 MiB) the 50 MB L2
TRIAD_SIZES = {"cache": 1 << 22, "dram": 1 << 28}
#: random full-space DGEMM configs a quick run tunes on a card (seed 0,
#: the sample of ``tune --benchmark dgemm --full --strategy random``)
CARD_DGEMM_BUDGET = 16


def dgemm_tuner(quick: bool, device: str, settings) -> Tuner:
    """The DGEMM search. A quick run on a card samples the full space:
    the quick corner's products (dims <= 1024) take tens of microseconds
    there, which the host clock around launch + synchronize cannot tell
    from the dispatch, so its F_p would be the host's, not the card's."""
    if quick and device == "cuda":
        return Tuner(dgemm_space(False), settings,
                     strategy=RandomSearchStrategy(budget=CARD_DGEMM_BUDGET,
                                                   seed=0))
    return Tuner(dgemm_space(quick), settings)


def run(quick: bool = True, cache_dir: str | None = None,
        device: str = "cuda") -> dict:
    device = resolve_device(device).type
    settings = dataclasses.replace(paper_settings(quick),
                                   use_ci_convergence=True,
                                   use_inner_prune=True,
                                   use_outer_prune=True)
    # Each TRIAD size probes a different memory subsystem: the sizes are
    # measurements, not competitors, so incumbent pruning stays off (a
    # pruned DRAM stream would be a truncated bandwidth estimate).
    triad_settings = dataclasses.replace(settings, use_inner_prune=False,
                                         use_outer_prune=False)
    peak_tuner = dgemm_tuner(quick, device, settings)
    triad_tuner = Tuner(grid(n_bytes=tuple(TRIAD_SIZES.values())),
                        triad_settings)
    dgemm_bench = dgemm_benchmark(device)
    triad_bench = triad_benchmark(device)

    fp = hardware_fingerprint(device)
    if cache_dir is not None:
        peak = TuningSession("roofline", peak_tuner, dgemm_bench,
                             cache_dir=cache_dir, fingerprint=fp,
                             benchmark_name="dgemm").run()
        bw = TuningSession("roofline", triad_tuner, triad_bench,
                           cache_dir=cache_dir, fingerprint=fp,
                           benchmark_name="triad").run()
        # across all fingerprints: a cache carried over from another
        # machine still renders as its own dashboard section
        trials = load_trials(f"{cache_dir}/roofline.jsonl")
    else:
        peak = peak_tuner.tune(dgemm_bench)
        bw = triad_tuner.tune(triad_bench)
        trials = (trials_from_result(peak, "dgemm", fp)
                  + trials_from_result(bw, "triad", fp))

    peak_flops = peak.best_score * 1e9
    by_size = {t.config["n_bytes"]: t.result.score for t in bw.trials
               if not t.result.pruned}
    bw_cache = by_size.get(TRIAD_SIZES["cache"], 0.0) * 1e9
    bw_dram = by_size.get(TRIAD_SIZES["dram"], 0.0) * 1e9

    reports, skipped = build_reports(trials)
    dgemm_I = operational_intensity(
        2 * 1024 ** 3, 3 * 1024 * 1024 * 4)  # n=m=k=1024 f32
    rows = [{
        "quantity": "peak compute",
        "value": f"{peak_flops/1e9:.1f} GFLOP/s",
    }, {
        "quantity": "bw (cache)", "value": f"{bw_cache/1e9:.1f} GB/s",
    }, {
        "quantity": "bw (dram)", "value": f"{bw_dram/1e9:.1f} GB/s",
    }, {
        "quantity": "ridge I (dram)",
        "value": f"{ridge_point(peak_flops, max(bw_dram, 1.0)):.1f} FLOP/B",
    }, {
        "quantity": "TRIAD I", "value": f"{TRIAD_INTENSITY:.4f} FLOP/B",
    }, {
        "quantity": "DGEMM-1024 I", "value": f"{dgemm_I:.1f} FLOP/B",
    }]
    print_table(f"Fig. 1 analog: empirical roofline ({fp})", rows)
    print()
    markdown = render_markdown(reports, skipped)
    print(markdown)
    emit("roofline/peak_gflops", 0.0, f"{peak_flops/1e9:.1f}")
    emit("roofline/bw_dram_gbps", 0.0, f"{bw_dram/1e9:.1f}")
    # return THIS machine's model: a multi-fingerprint resume cache sorts
    # reports by fingerprint, so index 0 could be a stale machine
    model = next((r.model for r in reports if r.fingerprint == fp), None)
    return {"peak_flops": peak_flops, "bw_dram": bw_dram,
            "bw_cache": bw_cache, "fingerprint": fp,
            "csv": model.to_csv() if model is not None else "",
            "markdown": markdown, "reports": reports}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench."
                                      "roofline_model",
                                 description=__doc__)
    ap.add_argument("--cache-dir", default=None,
                    help="persist both runs as the 'roofline' session here")
    ap.add_argument("--full", action="store_true",
                    help="paper Table I budgets and DGEMM space")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run(quick=not args.full, cache_dir=args.cache_dir, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
