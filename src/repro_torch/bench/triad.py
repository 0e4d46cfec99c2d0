"""Table VI analog: TRIAD bandwidth per memory subsystem.

Sweeps the working-set size across cache-resident and DRAM-streaming
regimes (the paper's L3-vs-DRAM distinction; on an H100 the 50 MB L2
against HBM3) with CI-converged evaluation through the hand-written TRIAD
kernel, and reports the peak bandwidth of each regime.

    python -m repro_torch.bench.triad [--full] [--device cpu]
"""

from __future__ import annotations

import dataclasses

from ..core import Evaluator
from ..device import resolve_device
from .common import (bench_main, emit, paper_settings, print_table,
                     triad_invocation_factory, where)

# working-set sizes: 256KiB (L2-resident) .. 512MiB (DRAM-streaming)
SIZES = [1 << 18, 1 << 20, 1 << 22, 1 << 24, 1 << 26, 1 << 28, 1 << 29]


def run(quick: bool = True, device: str = "cuda") -> list[dict]:
    device = resolve_device(device).type
    settings = dataclasses.replace(paper_settings(quick),
                                   use_ci_convergence=True,
                                   max_iterations=20 if quick else 200)
    ev = Evaluator(settings)
    rows = []
    sizes = SIZES[:5] if quick else SIZES
    for nbytes in sizes:
        r = ev.evaluate(triad_invocation_factory(nbytes, device=device))
        regime = "cache" if nbytes <= (1 << 24) else "dram"
        rows.append({"working_set": f"{nbytes >> 20}MiB" if nbytes >= 1 << 20
                     else f"{nbytes >> 10}KiB",
                     "gbytes_per_s": round(r.score, 2),
                     "regime": regime,
                     "samples": r.total_samples})
        emit(f"triad/{nbytes >> 10}KiB", 1e6 / max(r.score, 1e-9),
             f"gbps={r.score:.2f};samples={r.total_samples}")
    peak_cache = max(r["gbytes_per_s"] for r in rows
                     if r["regime"] == "cache")
    peak_dram = max((r["gbytes_per_s"] for r in rows
                     if r["regime"] == "dram"), default=peak_cache)
    print_table(f"Table VI analog: TRIAD bandwidth ({where(device)})", rows)
    print(f"  peak cache-resident: {peak_cache:.1f} GB/s   "
          f"peak DRAM-stream: {peak_dram:.1f} GB/s")
    return rows


if __name__ == "__main__":
    raise SystemExit(bench_main(run, __doc__))
