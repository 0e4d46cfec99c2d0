"""Tables IV/V analog: autotuned matmul peak for this device.

Finds the (n, m, k) maximizing GFLOP/s with the C+I+O-optimized search and
contrasts the autotuned optimum against the square m=n=k constraint the
paper criticizes (Intel's guide used m=n=k=1000 and reached 52% of peak;
the paper's non-square optima reach 75-98%). On a card the quick search
runs over :func:`~repro_torch.bench.common.card_dgemm_space`, which holds
no square config, so the square point is n=m=k at the middle of its n
range, evaluated directly (as in the JAX package's bench).

    python -m repro_torch.bench.matmul_peak [--full] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import time

from ..core import Evaluator, Tuner
from ..device import resolve_device
from .common import (bench_main, dgemm_benchmark, dgemm_invocation_factory,
                     emit, paper_dgemm_space, paper_settings, print_table,
                     where)


def run(quick: bool = True, device: str = "cuda") -> dict:
    device = resolve_device(device).type
    space = paper_dgemm_space(quick, device)
    settings = dataclasses.replace(paper_settings(quick),
                                   use_ci_convergence=True,
                                   use_inner_prune=True,
                                   use_outer_prune=True)
    bench = dgemm_benchmark(device)
    t0 = time.perf_counter()
    result = Tuner(space, settings).tune(bench)
    dt = time.perf_counter() - t0

    # the paper's square-matrix comparison (Intel guide constraint)
    square = space.constrain(lambda c: c["n"] == c["m"] == c["k"])
    best_square, score_square = None, None
    if square.cardinality:
        sq = Tuner(square, settings).tune(bench)
        best_square, score_square = sq.best_config, sq.best_score
    else:
        # evaluate n=m=k at the middle of the range directly
        n = sorted(space.params[0].values)[len(space.params[0].values) // 2]
        ev = Evaluator(settings)
        score_square = ev.evaluate(
            dgemm_invocation_factory(n, n, n, device=device)).score
        best_square = {"n": n, "m": n, "k": n}

    rows = [{
        "config": "autotuned",
        "dims": f"{result.best_config['n']},{result.best_config['m']},"
                f"{result.best_config['k']}",
        "gflops": round(result.best_score, 1),
        "rel": "1.00x",
    }, {
        "config": "square (m=n=k)",
        "dims": f"{best_square['n']},{best_square['m']},{best_square['k']}",
        "gflops": round(score_square, 1),
        "rel": f"{score_square / result.best_score:.2f}x",
    }]
    print_table(f"Table IV/V analog: matmul peak ({where(device)})", rows)
    emit("matmul_peak/autotuned", dt * 1e6,
         f"gflops={result.best_score:.1f};dims={rows[0]['dims']}")
    emit("matmul_peak/square", dt * 1e6,
         f"gflops={score_square:.1f};ratio={score_square/result.best_score:.3f}")
    return {"autotuned": result.best_score, "square": score_square,
            "dims": result.best_config, "square_dims": best_square,
            "rows": rows}


if __name__ == "__main__":
    raise SystemExit(bench_main(run, __doc__))
