"""Beyond-paper: tile autotuning of the hand-written GEMM on this device.

The counterpart of the JAX package's Pallas tile search. That search
scores (bm, bn, bk) tiles with a TPU cost model (VMEM working set, MXU
alignment), which has no meaning on a card; here the tunables are the
CUDA GEMM kernel's tiles (:func:`~repro_torch.bench.common.gemm_tiled_space`,
bounded by the block's opt-in shared memory) and the objective is their
*measured* GFLOP/s at :data:`~repro_torch.bench.common.GEMM_TILED_SHAPE`
in float32, under the JAX bench's settings. The winning tile's product
is then checked against ``matmul_ref`` on the same operands.

    python -m repro_torch.bench.kernel_autotune [--device cpu]
"""

from __future__ import annotations

import torch

from ..core import Direction, EvaluationSettings, Tuner
from ..device import resolve_device
from ..kernels.matmul import matmul, matmul_ref, smem_bytes
from .common import (bench_main, block_smem_limit, emit,
                     gemm_tiled_benchmark, gemm_tiled_space, print_table,
                     where)


def product_tol(k: int) -> dict:
    """f32 rtol/atol of the winner's check: 1e-4 up to k = 256, atol
    growing linearly beyond it (the rounding gap between the kernel's
    sequential FMA chain and the library's blocked sum grows about
    linearly in k)."""
    return {"rtol": 1e-4, "atol": 1e-4 * max(1.0, k / 256.0)}


def run(quick: bool = True, device: str = "cuda") -> dict:
    device = resolve_device(device).type
    space = gemm_tiled_space(smem_limit=block_smem_limit(device))
    settings = EvaluationSettings(max_invocations=1, max_iterations=3,
                                  max_time_s=1.0,
                                  use_ci_convergence=True,
                                  use_inner_prune=True,
                                  direction=Direction.MAXIMIZE)
    bench = gemm_tiled_benchmark(device)
    result = Tuner(space, settings).tune(bench)
    best = result.best_config

    # functional check of the winning tile on the search's own operands
    a, b = bench.operands()
    tile = {"bm": best["bm"], "bn": best["bn"], "bk": best["bk"]}
    out = matmul(a, b, **tile)
    want = matmul_ref(a, b)
    err = float((out - want).abs().max())
    k = a.shape[1]
    torch.testing.assert_close(out, want, **product_tol(k))

    m, n = a.shape[0], b.shape[1]
    rows = [{"quantity": "search space", "value": space.cardinality},
            {"quantity": "best tile",
             "value": f"bm={best['bm']},bn={best['bn']},bk={best['bk']}"},
            {"quantity": "smem bytes",
             "value": f"{smem_bytes(best['bm'], best['bn'], best['bk'])}"},
            {"quantity": "measured GFLOP/s",
             "value": f"{result.best_score:.1f}"},
            {"quantity": "max err vs matmul_ref", "value": f"{err:.2e}"}]
    print_table(f"Beyond-paper: GEMM tile autotuning at {m}x{n}x{k} f32 "
                f"({where(device)})", rows)
    emit("kernel_autotune/best_tile", 0.0,
         f"bm={best['bm']};bn={best['bn']};bk={best['bk']};err={err:.1e}")
    return {"best": best, "err": err, "score": result.best_score,
            "trials": len(result.trials), "shape": {"m": m, "n": n, "k": k}}


if __name__ == "__main__":
    raise SystemExit(bench_main(run, __doc__))
