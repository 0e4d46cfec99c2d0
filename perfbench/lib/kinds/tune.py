"""A tile search: the port's tuner (``core.Tuner``) searching the
hand-written GEMM's tile space over ``bench.common``'s
``gemm_tiled_invocation_factory``, one session after another, each with
an empty trial cache and no warm start.

Traffic keys: ``tokens`` (M), ``k`` and ``n`` (keys of the configuration
file whose values are K and N), ``dtype``, ``technique`` (a row of
``core.standard_techniques``), ``quick_settings`` (the paper's settings
scaled for CI when true), ``warmup_sessions``, ``peak_window_s`` (host
seconds each winner is timed for after the window), ``peak_min_launches``.

Operands are drawn once a run from the seed, on the device.
"""

from __future__ import annotations

import collections
import math
import time

from torch.profiler import record_function

from .. import counts
from ..seeds import derive

__all__ = ["end_to_end", "judge", "release", "setup", "window"]


def _shape(run) -> tuple:
    t, conf = run.cell.traffic, run.cell.config
    return int(t["tokens"]), int(conf[t["n"]]), int(conf[t["k"]])


def _operands(run) -> tuple:
    import torch
    m, n, k = _shape(run)
    dtype = getattr(torch, run.cell.traffic["dtype"])
    gen = torch.Generator(device=run.device).manual_seed(
        derive(run.seed, "operands"))
    a = torch.randn((m, k), generator=gen, dtype=dtype, device=run.device)
    b = torch.randn((k, n), generator=gen, dtype=dtype, device=run.device)
    return a, b


def setup(run) -> None:
    import torch
    from repro_torch import core
    from repro_torch.bench import common
    t = run.cell.traffic
    dtype = getattr(torch, t["dtype"])
    settings, order = core.standard_techniques(
        common.paper_settings(quick=bool(t["quick_settings"])))[
        t["technique"]]
    run.state.update(
        core=core, common=common, operands=_operands(run), order=order,
        settings=settings,
        space=common.gemm_tiled_space(common.block_smem_limit(run.device),
                                      dtype))
    for _ in range(int(t["warmup_sessions"])):
        _session(run)


def _session(run) -> dict:
    """One tuning session; besides the tuner's result, the seconds of its
    samples as their own sampler measured them (work over rate)."""
    st = run.state
    a, b = st["operands"]
    m, n, k = _shape(run)
    gflop = counts.gemm_flops(m, n, k) / 1e9
    sample_s = [0.0]

    def benchmark(cfg):
        factory = st["common"].gemm_tiled_invocation_factory(
            cfg["bm"], cfg["bn"], cfg["bk"], lambda: (a, b),
            device=run.device)

        def invocation():
            sampler = factory()

            def sample():
                x = sampler()
                sample_s[0] += gflop / x
                return x
            return sample
        return invocation

    t0 = time.perf_counter()
    with record_function("perfbench.session"):
        res = st["core"].Tuner(st["space"], st["settings"],
                               order=st["order"]).tune(benchmark,
                                                       validate="off")
    wall = time.perf_counter() - t0
    best = res.best_config
    return {"wall_s": wall, "samples": res.total_samples,
            "sample_s": sample_s[0], "trials": len(res.trials),
            "winner": None if best is None else
            (best["bm"], best["bn"], best["bk"])}


def window(run, seconds: float) -> None:
    sessions = []
    run.sync()
    t0 = time.perf_counter()
    while True:
        sessions.append(_session(run))
        if time.perf_counter() - t0 >= seconds:
            break
    run.sync()
    run.window_s = time.perf_counter() - t0
    run.records["sessions"] = sessions
    run.records["winners"] = collections.Counter(
        s["winner"] for s in sessions if s["winner"] is not None)
    run.attempted = len(sessions)
    run.failed = sum(s["winner"] is None for s in sessions)


def _kernel(run, tile: tuple):
    """The tile's GEMM through the path the window drives: the
    executable cache's callable for ``bench.common.matmul``."""
    st = run.state
    bm, bn, bk = tile
    return st["core"].default_cache().compile(
        st["common"].matmul, st["operands"],
        static={"bm": bm, "bn": bn, "bk": bk})


def end_to_end(run) -> dict:
    """``search_s``: the window over the sessions completed in it;
    ``peak_gflops``: each session's winner timed by the host clock over
    back-to-back launches (at least ``peak_window_s``), pooled over the
    sessions (their work over their time)."""
    t = run.cell.traffic
    m, n, k = _shape(run)
    flops = counts.gemm_flops(m, n, k)
    a, b = run.state["operands"]
    work = time_s = 0.0
    for tile, count in run.records["winners"].items():
        f = _kernel(run, tile)
        f(a, b)
        run.sync()
        t0 = time.perf_counter()
        f(a, b)
        run.sync()
        one = max(time.perf_counter() - t0, 1e-9)
        reps = max(int(t["peak_min_launches"]),
                   math.ceil(float(t["peak_window_s"]) / one))
        t0 = time.perf_counter()
        for _ in range(reps):
            f(a, b)
        run.sync()
        elapsed = time.perf_counter() - t0
        work += count * reps * flops
        time_s += count * elapsed
    return {"search_s": run.window_s / len(run.records["sessions"]),
            "peak_gflops": work / time_s / 1e9}


def release(run) -> None:
    """The tuner keeps nothing between sessions but the executable cache
    (held for the winners' check) and the operands."""


def judge(run, precision: str) -> dict:
    """``c_err``: the largest max |C - C64| / max |C64| over the winners'
    products, C64 the float64 reference on operands drawn afresh from
    the seed; with ``precision`` other than ``f32``, the reference's own
    product in that precision stands in for the program's."""
    import torch
    from perfbench.reference import gemm
    a, b = _operands(run)
    c64 = gemm.product(a, b)
    scale = float(c64.abs().max())
    worst = 0.0
    if precision != "f32":
        tiles = [gemm.product(a, b, precision)]
    else:
        tiles = [_kernel(run, t)(*run.state["operands"])
                 for t in sorted(run.records["winners"])]
    for c in tiles:
        err = float((c.double() - c64).abs().max()) / scale
        worst = max(worst, err if math.isfinite(err) else math.inf)
        del c
    if not tiles:
        worst = math.inf
    del c64
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"c_err": worst}
