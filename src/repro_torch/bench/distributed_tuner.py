"""Beyond-paper: execution backends and search strategies for the
CI-pruned search (the JAX package's ``benchmarks/bench_distributed_tuner.py``).

Part one runs the same exhaustive DGEMM search under the execution
backends — serial (the paper's loop), thread-pool (live incumbent
sharing), process-pool (per-batch incumbent all-reduce), and the
simulated fleet of 4 and 16 workers — and reports each backend's
wall-clock, sample count, and found optimum (concurrent timing perturbs
the measured GFLOP/s, so backends can disagree on noisy hardware). Part
two compares the search *strategies* — exhaustive, successive halving,
budgeted random, neighborhood hill-climb, surrogate, bandit — through the
same engine. With a ``cache_dir`` (``bench.run --resume``) every
variant's trials persist to a named session and reruns skip completed
configs, except halving's rung trials, which are persisted but never
replayed.

The DGEMM is ``torch.matmul`` in full float32, as in the paper benches
(the JAX package's is ``jnp.dot``), over
:func:`~repro_torch.bench.common.paper_dgemm_space`. The serial search's
winner is then computed once by the hand-written GEMM kernel
(:func:`repro_torch.kernels.matmul.matmul`) and checked against
``matmul_ref`` on the same operands; its error is in the backend table's
title.

    python -m repro_torch.bench.distributed_tuner [--full] [--device cpu]
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core import (NeighborhoodStrategy, ProcessPoolBackend,
                    RandomSearchStrategy, SimulatedShardedBackend,
                    SuccessiveHalvingStrategy, ThreadPoolBackend,
                    TrialCache, Tuner)
from ..device import resolve_device
from ..kernels.matmul import matmul, matmul_ref
from ..surrogate import BanditStrategy, SurrogateStrategy
from .common import (bench_main, dgemm_benchmark, dgemm_data, emit,
                     paper_dgemm_space, paper_settings, print_table, where)
from .kernel_autotune import product_tol

BACKENDS = ("serial", "thread4", "process4", "simulated4", "simulated16")
STRATEGIES = ("exhaustive", "halving", "random", "neighborhood",
              "surrogate", "bandit")


def _backend(name: str):
    return {"serial": None, "thread4": ThreadPoolBackend(4),
            "process4": ProcessPoolBackend(4),
            "simulated4": SimulatedShardedBackend(4),
            "simulated16": SimulatedShardedBackend(16)}[name]


def kernel_check(cfg: dict, device: str) -> float:
    """Max abs error of the hand-written GEMM against ``matmul_ref`` at
    DGEMM config ``cfg`` (raises beyond the product tolerance)."""
    import torch
    n, m, k = cfg["n"], cfg["m"], cfg["k"]
    a, b = dgemm_data(n, m, k, seed=0, device=device)
    out, want = matmul(a, b), matmul_ref(a, b)
    torch.testing.assert_close(out, want, **product_tol(k))
    return float((out - want).abs().max())


def run(quick: bool = True, cache_dir: Optional[str] = None,
        device: str = "cuda") -> list[dict]:
    device = resolve_device(device).type
    space = paper_dgemm_space(quick, device)
    settings = dataclasses.replace(paper_settings(quick),
                                   use_ci_convergence=True,
                                   use_inner_prune=True,
                                   use_outer_prune=True)
    bench = dgemm_benchmark(device)
    rows = []
    serial_result = None
    serial_wall = None
    for name in BACKENDS:
        cache = None
        if cache_dir is not None:
            # one session per backend variant: resume works per-variant and
            # the backends stay comparable (no cross-variant cache hits)
            cache = TrialCache(f"{cache_dir}/dgemm-{name}.jsonl").bound(
                f"dgemm-{name}")
        result = Tuner(space, settings).tune(bench, backend=_backend(name),
                                             cache=cache)
        wall = result.parallel_time_s
        # an all-cache-hits replay measures nothing: don't let near-zero
        # walls masquerade as scheduling speedup in the table or CSV stream
        replay = result.n_cached == len(result.trials)
        if serial_wall is None and not replay:
            serial_wall = wall
        if name == "serial":
            serial_result = result
        if replay:
            speedup = "cached"
        elif serial_wall is None:
            speedup = "-"
        else:
            speedup = f"{serial_wall / max(wall, 1e-9):.2f}x"
        rows.append({
            "backend": name,
            "workers": result.n_workers,
            "best_dims": _d(result.best_config),
            "gflops": round(result.best_score, 1),
            "samples": result.total_samples,
            "cached": result.n_cached,
            "wall_s": round(wall, 2),
            "speedup": speedup,
        })
        emit(f"distributed_tuner/{name}", wall * 1e6,
             f"gflops={result.best_score:.1f};samples={result.total_samples}"
             f";cached={result.n_cached}" + (";replay" if replay else ""))
    err = kernel_check(serial_result.best_config, device)
    print_table(f"Beyond-paper: execution backends for CI-pruned search "
                f"({where(device)}; winner through the hand GEMM: max err "
                f"{err:.2e} vs matmul_ref)", rows)
    rows += run_strategies(space, settings, bench, cache_dir=cache_dir,
                           exhaustive=serial_result)
    return rows


def run_strategies(space, settings, bench, cache_dir: Optional[str] = None,
                   exhaustive=None) -> list[dict]:
    """Strategy comparison through the shared engine (serial backend, so
    trial/sample counts are scheduling-independent). The exhaustive row
    reuses the backend table's serial run when available. The
    model-guided rows (surrogate, bandit) run at the same proposal budget
    as random search."""
    budget = max(4, space.cardinality // 3)
    strategies = [("halving", SuccessiveHalvingStrategy()),
                  ("random", RandomSearchStrategy(budget=budget, seed=0)),
                  ("neighborhood", NeighborhoodStrategy(budget=budget)),
                  ("surrogate", SurrogateStrategy(budget=budget, seed=0)),
                  ("bandit", BanditStrategy(budget=budget, seed=0))]
    rows = []
    if exhaustive is not None:
        rows.append(_strategy_row("exhaustive", exhaustive))
    for name, strategy in strategies:
        cache = None
        if cache_dir is not None:
            cache = TrialCache(f"{cache_dir}/dgemm-strat-{name}.jsonl").bound(
                f"dgemm-strat-{name}")
        result = Tuner(space, settings, strategy=strategy).tune(
            bench, cache=cache)
        rows.append(_strategy_row(name, result))
        emit(f"distributed_tuner/strategy_{name}",
             result.parallel_time_s * 1e6,
             f"gflops={result.best_score:.1f};trials={len(result.trials)}"
             f";samples={result.total_samples}")
    print_table("Beyond-paper: search strategies through the shared engine",
                rows)
    return rows


def _strategy_row(name, result) -> dict:
    return {
        "strategy": name,
        "best_dims": _d(result.best_config),
        "gflops": round(result.best_score, 1),
        "trials": len(result.trials),
        "rounds": len(result.batches),
        "samples": result.total_samples,
        "pruned": result.n_pruned,
        "wall_s": round(result.parallel_time_s, 2),
    }


def _d(cfg):
    return f"{cfg['n']},{cfg['m']},{cfg['k']}" if cfg else "-"


if __name__ == "__main__":
    raise SystemExit(bench_main(run, __doc__))
