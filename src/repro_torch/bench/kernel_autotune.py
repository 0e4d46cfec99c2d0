"""Beyond-paper: tile autotuning of the hand-written GEMM on this device.

The counterpart of the JAX package's Pallas tile search. That search
scores (bm, bn, bk) tiles with a TPU cost model (VMEM working set, MXU
alignment) of 2-byte operand tiles, which has no meaning on a card; here
the tunables are the GEMM kernels' tiles
(:func:`~repro_torch.bench.common.gemm_tiled_space`, bounded by the
block's opt-in shared memory) and the objective is their *measured*
GFLOP/s at :data:`~repro_torch.bench.common.GEMM_TILED_SHAPE`, under the
JAX bench's settings, in two sessions: float32 (the CUDA-core kernel),
then bfloat16 (the tensor-core kernel) on the same draws. Each session's
winning tile is then checked against ``matmul_ref`` on its operands.

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

#: the bf16 winner's check: the reference's bf16 bound (tests/test_kernels.py)
BF16_TOL = {"rtol": 3e-2, "atol": 3e-2}


def product_tol(k: int) -> dict:
    """f32 rtol/atol of the winner's check: 1e-4 up to k = 256, atol
    growing linearly beyond it (the rounding gap between the kernel's
    sequential FMA chain and the library's blocked sum grows about
    linearly in k)."""
    return {"rtol": 1e-4, "atol": 1e-4 * max(1.0, k / 256.0)}


def _session(dtype: torch.dtype, device: str) -> dict:
    """One tile search in ``dtype``, its winner checked against
    ``matmul_ref``, and the GEMM launches it made by route (this
    process's)."""
    space = gemm_tiled_space(smem_limit=block_smem_limit(device),
                             dtype=dtype)
    settings = EvaluationSettings(max_invocations=1, max_iterations=3,
                                  max_time_s=1.0,
                                  use_ci_convergence=True,
                                  use_inner_prune=True,
                                  direction=Direction.MAXIMIZE)
    bench = gemm_tiled_benchmark(device, dtype)
    before = dict(matmul.route_launches)
    result = Tuner(space, settings).tune(bench)
    launches = {path: n - before[path]
                for path, n in matmul.route_launches.items()}
    best = result.best_config

    # functional check of the winning tile on the search's own operands
    a, b = bench.operands()
    tile = {"bm": best["bm"], "bn": best["bn"], "bk": best["bk"]}
    out = matmul(a, b, **tile)
    want = matmul_ref(a, b)
    err = float((out.float() - want.float()).abs().max())
    torch.testing.assert_close(
        out, want, **(product_tol(a.shape[1]) if dtype == torch.float32
                      else BF16_TOL))
    return {"best": best, "err": err, "score": result.best_score,
            "trials": len(result.trials), "space": space.cardinality,
            "smem": smem_bytes(best["bm"], best["bn"], best["bk"], dtype),
            "launches": launches,
            "shape": {"m": a.shape[0], "n": b.shape[1], "k": a.shape[1]}}


def _rows(res: dict, prefix: str = "") -> list[dict]:
    best = res["best"]
    return [{"quantity": prefix + "search space", "value": res["space"]},
            {"quantity": prefix + "best tile",
             "value": f"bm={best['bm']},bn={best['bn']},bk={best['bk']}"},
            {"quantity": prefix + "smem bytes", "value": f"{res['smem']}"},
            {"quantity": prefix + "measured GFLOP/s",
             "value": f"{res['score']:.1f}"},
            {"quantity": prefix + "max err vs matmul_ref",
             "value": f"{res['err']:.2e}"}]


def run(quick: bool = True, device: str = "cuda") -> dict:
    device = resolve_device(device).type
    f32 = _session(torch.float32, device)
    bf16 = _session(torch.bfloat16, device)
    m, n, k = (f32["shape"][d] for d in "mnk")
    print_table(f"Beyond-paper: GEMM tile autotuning at {m}x{n}x{k}, f32 "
                f"and bf16 ({where(device)})",
                _rows(f32) + _rows(bf16, "bf16 "))
    best, err = f32["best"], f32["err"]
    emit("kernel_autotune/best_tile", 0.0,
         f"bm={best['bm']};bn={best['bn']};bk={best['bk']};err={err:.1e}")
    return {"best": best, "err": err, "score": f32["score"],
            "trials": f32["trials"], "shape": f32["shape"],
            "bf16": {key: bf16[key] for key in
                     ("best", "err", "score", "trials", "launches")}}


if __name__ == "__main__":
    raise SystemExit(bench_main(run, __doc__))
