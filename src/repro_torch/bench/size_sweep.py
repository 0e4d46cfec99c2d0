"""Fig. 6 analog: per-configuration evaluation time and performance as a
function of matrix size — the basis for the paper's observation that search
*order* matters (reversal starts at the expensive end).

On the host the sizes are the JAX package's (:data:`SIZES`). On a card
they are :data:`CARD_SIZES`: products of n <= 1024 take tens of
microseconds there, which the host clock cannot tell from the dispatch.

    python -m repro_torch.bench.size_sweep [--full] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import time

from ..core import Evaluator
from ..device import resolve_device
from .common import (bench_main, dgemm_invocation_factory, emit,
                     paper_settings, print_table)

SIZES = [128, 256, 512, 1024, 1536]
#: n = m = k on a card: 0.27 to 1100 GFLOP a product
CARD_SIZES = [512, 1024, 2048, 4096, 8192]


def run(quick: bool = True, device: str = "cuda") -> list[dict]:
    device = resolve_device(device).type
    settings = dataclasses.replace(paper_settings(quick),
                                   use_ci_convergence=True)
    ev = Evaluator(settings)
    rows = []
    ladder = CARD_SIZES if device == "cuda" else SIZES
    sizes = ladder[:4] if quick else ladder
    for n in sizes:
        t0 = time.perf_counter()
        r = ev.evaluate(dgemm_invocation_factory(n, n, n, device=device))
        dt = time.perf_counter() - t0
        rows.append({"n=m=k": n, "gflops": round(r.score, 1),
                     "eval_time_s": round(dt, 3),
                     "samples": r.total_samples})
        emit(f"size_sweep/n{n}", dt * 1e6 / max(r.total_samples, 1),
             f"gflops={r.score:.1f}")
    print_table("Fig. 6 analog: time & performance vs matrix size", rows)
    return rows


if __name__ == "__main__":
    raise SystemExit(bench_main(run, __doc__))
