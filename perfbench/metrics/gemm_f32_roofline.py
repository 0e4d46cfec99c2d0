"""gemm_f32_roofline (CUDA kernel ``csrc/matmul_f32_sm90.cu``): the
GEMM's bound over the winning tile's mean device time in the trace, in
percent. The bound is the larger of 2MNK / 165 TFLOP/s (f32-accurate
arithmetic, TF32's rate over three) and the bytes of A, B and C once
over 3.35 TB/s. Each session's winner weighs once. It moves
``peak_gflops``."""

import re

from perfbench.lib import counts, peaks

_NAME = re.compile(r"matmul_f32_sm90_kernel<(\d+), ?(\d+), ?(\d+)>")


def read(run):
    winners = run.records.get("winners")
    if run.trace is None or not winners:
        return None
    m, n, k = (int(run.cell.traffic["tokens"]),
               int(run.cell.config[run.cell.traffic["n"]]),
               int(run.cell.config[run.cell.traffic["k"]]))
    times = {}
    for name, _, seconds in run.trace.kernels:
        hit = _NAME.search(name)
        if hit:
            times.setdefault(tuple(map(int, hit.groups())), []).append(
                seconds)
    weighted = [(count, sum(times[t]) / len(times[t]))
                for t, count in winners.items() if times.get(t)]
    if not weighted:
        return None
    mean = sum(c * s for c, s in weighted) / sum(c for c, _ in weighted)
    bound = peaks.bound_s(counts.gemm_flops(m, n, k),
                          counts.gemm_bytes(m, n, k),
                          peaks.F32_ACCURATE_FLOPS)
    return 100.0 * bound / mean
