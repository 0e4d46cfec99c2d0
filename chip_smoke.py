#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout: the kernels are built from
``src/repro_torch/csrc`` at first use. Phases, each of which fails the
run when it fails:

1. card      — ``nvidia-smi`` name and power limit; torch, CUDA, nvcc.
2. build     — compile both CUDA kernels for sm_90a; print the seconds.
3. checks    — each kernel against its plain PyTorch version on the card:
               GEMM at every tile of the table at 4096x2048x6144 f32 and
               at 300x450x200 and 1024x256x128 in f32 and bf16; TRIAD at
               n in {1024, 2**20 + 17, 2**26} in f32 and bf16 (plus an
               unaligned view that takes the scalar path), and at every
               length of the ``triad --full`` ladder in f32.
4. timing    — CUDA-event times of each kernel at the main path's shapes
               (each checked against its plain version on the same
               tensors first) beside its bound, its plain version and one
               PyTorch call that computes the same function; TRIAD also
               replayed from a CUDA graph (device time without the host's
               dispatch); and the host cost of one tuner sample at
               n = 1024, split into the wrapper's dispatch and the
               sampler's synchronize.
5. main path — ``python -m repro_torch.tune`` for ``triad --full``,
               ``dgemm --full --strategy random --budget 16 --seed 0`` and
               ``gemm_tiled --report``, then the roofline-model bench with
               its cache (4 MiB) and DRAM (256 MiB) TRIAD sizes, which on
               a card tunes DGEMM over the same 16 random configs of the
               full space as the ``dgemm --full`` session; the
               rendered roofline must hold a DGEMM F_p within
               F_P_AGREEMENT of the ``dgemm --full`` session's and at
               least two TRIAD subsystems, and both kernels must have
               launched.

The last three lines are the card line, one ``{"kernels": [...]}`` JSON
object and ``{"ok": true, "device": {...}}``. Without a card, or outside
a checkout, the script exits non-zero and prints neither.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
SRC = REPO / "src"
WORK = REPO / "build" / "chip_smoke"

GEMM_MAIN = (4096, 2048, 6144)              # (m, n, k) of the tile search
GEMM_SMALL = ((300, 450, 200), (1024, 256, 128))
TRIAD_CHECK_N = (1024, 2 ** 20 + 17, 2 ** 26)
TRIAD_SIZES = {"cache": 1 << 22, "dram": 1 << 28}  # roofline-model bytes
F32_PEAK = 67e12                           # H100 SXM data sheet, 700 W
HBM_PEAK = 3.35e12
SUBPROCESS_TIMEOUT_S = 420
# The roofline model and the ``dgemm --full`` session time the same random
# configs with the same sampler, so their F_p differ by run-to-run noise
# and the model's smaller per-config budget only.
F_P_AGREEMENT = (0.8, 1.25)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def phase(name: str) -> None:
    print(f"\n== {name} ==", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def gemm_tol(dtype, k: int) -> dict:
    """rtol/atol of the GEMM checks. bf16: 3e-2 (tests/test_kernels.py).
    f32: 1e-4 up to k = 256, as in the tests; beyond it atol grows with k,
    because the kernel's sequential FMA chain and the library's blocked
    sum round differently, and the rounding gap of a length-k float32
    dot product grows about linearly in k (partial sums grow like sqrt(k),
    so do the per-step roundings, over k steps)."""
    import torch
    if dtype == torch.bfloat16:
        return {"rtol": 3e-2, "atol": 3e-2}
    return {"rtol": 1e-4, "atol": 1e-4 * max(1.0, k / 256.0)}


def triad_tol(dtype) -> dict:
    """f32: the kernel rounds the multiply and the add separately, as the
    plain version does, so it should agree exactly; 2e-5 is the tests'
    bound. bf16: the kernel rounds once where the plain version rounds
    twice, so they may differ by an ulp: 3e-2, the tests' bound."""
    import torch
    if dtype == torch.bfloat16:
        return {"rtol": 3e-2, "atol": 3e-2}
    return {"rtol": 2e-5, "atol": 2e-5}


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls,
    between two CUDA events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, got, want, tol: dict) -> float:
    """Max abs error of ``got`` against ``want``; fails outside ``tol``.
    ``got`` is then filled with NaN, so a later launch that writes
    nothing into a recycled buffer cannot pass on stale results."""
    import torch
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs()
    bound = tol["atol"] + tol["rtol"] * want.float().abs()
    worst = float(err.max())
    if bool((err > bound).any()):
        n_bad = int((err > bound).sum())
        fail(f"{name}: {n_bad} elements outside rtol={tol['rtol']} "
             f"atol={tol['atol']} (max abs err {worst:.3e})")
    got.fill_(float("nan"))
    return worst


def graph_ms(fn, launches: int = 50, replays: int = 10) -> float:
    """Device milliseconds per call with the host out of the way: capture
    ``launches`` calls in one CUDA graph, time ``replays`` replays between
    CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def host_us_per_call(fn, calls: int = 2000) -> float:
    """Host microseconds per call of back-to-back calls that each take
    far less device time than their dispatch (the wrapper's overhead)."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def host_us_per_sample(fn, samples: int = 2000) -> float:
    """Median host microseconds of ``fn(); torch.cuda.synchronize()``,
    the bracket the tuner's ``timed_sampler`` puts around every sample."""
    import torch
    for _ in range(20):
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


def run_tune(args: list[str]) -> tuple[str, dict]:
    """One ``python -m repro_torch.tune`` session; returns its output and
    the launch counts of its footer's ``kernels`` line."""
    cmd = [sys.executable, "-m", "repro_torch.tune", "--session", "smoke",
           "--cache-dir", str(WORK / "sessions"), *args]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    print("$ " + " ".join(cmd[1:]), flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=SUBPROCESS_TIMEOUT_S)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-6000:])
        print(proc.stderr[-6000:], file=sys.stderr)
        fail(f"tune {' '.join(args)} exited {proc.returncode}")
    out = proc.stdout
    (WORK / f"tune_{args[1]}.log").write_text(out + proc.stderr,
                                              encoding="utf-8")
    m = re.search(r"^kernels   : (.*) launches$", out, re.M)
    if m is None:
        fail(f"tune {' '.join(args)}: no kernels line in its footer")
    counts = {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", m.group(1))}
    for key in ("best      :", "trials    :", "backend   :"):
        line = next((ln for ln in out.splitlines() if ln.startswith(key)),
                    None)
        if line is None:
            fail(f"tune {' '.join(args)}: no {key!r} line")
        print("  " + line)
    print(f"  {m.group(0)}   (process wall {dt:.1f}s)", flush=True)
    return out, counts


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no card to run on")
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    # -- 1. card -----------------------------------------------------------
    phase("card")
    card = card_line()
    print(card)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device "
          f"{torch.cuda.get_device_name(0)} "
          f"sm{''.join(map(str, torch.cuda.get_device_capability(0)))} "
          f"x{torch.cuda.device_count()}")
    print("nvcc: " + (nvcc_ver.splitlines()[-1] if nvcc_ver else "?"))

    from repro_torch import kernels
    from repro_torch.bench import roofline_model
    from repro_torch.bench.common import triad_length, triad_sizes
    from repro_torch.kernels import build
    from repro_torch.kernels.matmul import TILES, matmul, matmul_ref
    from repro_torch.kernels.triad import triad, triad_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 2. build ----------------------------------------------------------
    phase("build")
    fresh = not build.library_path().exists()
    t0 = time.perf_counter()
    build.library()
    print(f"kernel library {build.library_path()} "
          f"({'built' if fresh else 'found'} in "
          f"{time.perf_counter() - t0:.2f}s)")
    log = build.library_path().parent / "build.log"
    if log.exists():
        for line in log.read_text(encoding="utf-8").splitlines():
            if line.startswith("built in") or "Used" in line \
                    or "spill" in line and " 0 bytes spill" not in line:
                print("  " + line.strip())

    # -- 3. checks ---------------------------------------------------------
    phase("kernel checks")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev).to(dtype)

    errs = {"matmul": 0.0, "triad": 0.0}
    n_checks = {"matmul": 0, "triad": 0}
    m, n, k = GEMM_MAIN
    a, b = randn(m, k), randn(k, n)
    want = matmul_ref(a, b)
    for tile in TILES:
        before = matmul.launches
        got = matmul(a, b, bm=tile[0], bn=tile[1], bk=tile[2])
        torch.cuda.synchronize()
        if matmul.launches != before + 1:
            fail(f"matmul {tile}: launch counter did not move")
        errs["matmul"] = max(errs["matmul"], check_close(
            f"matmul {m}x{n}x{k} f32 tile {tile}", got, want,
            gemm_tol(torch.float32, k)))
        n_checks["matmul"] += 1
    print(f"matmul {m}x{n}x{k} f32: {len(TILES)} tiles ok, max abs err "
          f"{errs['matmul']:.3e} (tol {gemm_tol(torch.float32, k)})")
    del a, b, want, got
    for (m_, n_, k_) in GEMM_SMALL:
        for dtype in (torch.float32, torch.bfloat16):
            a, b = randn(m_, k_, dtype=dtype), randn(k_, n_, dtype=dtype)
            want = matmul_ref(a, b)
            worst = 0.0
            for tile in TILES:
                before = matmul.launches
                got = matmul(a, b, bm=tile[0], bn=tile[1], bk=tile[2])
                torch.cuda.synchronize()
                if matmul.launches != before + 1:
                    fail(f"matmul {tile}: launch counter did not move")
                worst = max(worst, check_close(
                    f"matmul {m_}x{n_}x{k_} {dtype} tile {tile}", got, want,
                    gemm_tol(dtype, k_)))
                n_checks["matmul"] += 1
            if dtype == torch.float32:
                errs["matmul"] = max(errs["matmul"], worst)
            print(f"matmul {m_}x{n_}x{k_} {dtype}: {len(TILES)} tiles ok, "
                  f"max abs err {worst:.3e}")
    for n_ in TRIAD_CHECK_N:
        for dtype in (torch.float32, torch.bfloat16):
            a, b = randn(n_ + 1, dtype=dtype), randn(n_ + 1, dtype=dtype)
            for label, (x, y) in (("aligned", (a[:n_], b[:n_])),
                                  ("offset view", (a[1:], b[1:]))):
                before = triad.launches
                got = triad(x, y, gamma=3.0)
                torch.cuda.synchronize()
                if triad.launches != before + 1:
                    fail("triad: launch counter did not move")
                worst = check_close(f"triad n={n_} {dtype} {label}", got,
                                    triad_ref(x, y, 3.0), triad_tol(dtype))
                if dtype == torch.float32:
                    errs["triad"] = max(errs["triad"], worst)
                n_checks["triad"] += 1
                print(f"triad n={n_} {dtype} {label}: ok, max abs err "
                      f"{worst:.3e}")
    for n_bytes in triad_sizes(False):      # the triad --full ladder, f32
        n_ = triad_length(n_bytes)
        x, y = randn(n_), randn(n_)
        before = triad.launches
        got = triad(x, y, gamma=3.0)
        torch.cuda.synchronize()
        if triad.launches != before + 1:
            fail("triad: launch counter did not move")
        worst = check_close(f"triad n={n_} f32", got, triad_ref(x, y, 3.0),
                            triad_tol(torch.float32))
        errs["triad"] = max(errs["triad"], worst)
        n_checks["triad"] += 1
        print(f"triad n={n_} ({n_bytes >> 10} KiB) f32: ok, max abs err "
              f"{worst:.3e}")
    del x, y, got
    torch.cuda.empty_cache()

    # -- 4. timing ---------------------------------------------------------
    phase("kernel timing (CUDA events)")
    m, n, k = GEMM_MAIN
    a, b = randn(m, k), randn(k, n)
    gemm_flops = 2.0 * m * n * k
    gemm_bound_ms = max(gemm_flops / F32_PEAK,
                        4.0 * (m * k + k * n + m * n) / HBM_PEAK) * 1e3
    tile_ms = {}
    for tile in TILES:
        tile_ms[tile] = cuda_ms(
            lambda t=tile: matmul(a, b, bm=t[0], bn=t[1], bk=t[2]), iters=10)
        print(f"matmul tile {tile}: {tile_ms[tile]:.4f} ms  "
              f"{gemm_flops / tile_ms[tile] / 1e9:.2f} TFLOP/s")
    best_tile = min(tile_ms, key=tile_ms.get)
    gemm_ms = tile_ms[best_tile]
    gemm_plain_ms = cuda_ms(lambda: matmul_ref(a, b), iters=10)
    gemm_lib_ms = cuda_ms(lambda: torch.matmul(a, b), iters=10)
    print(f"matmul {m}x{n}x{k} f32: kernel {gemm_ms:.4f} ms (tile "
          f"{best_tile}, {gemm_flops / gemm_ms / 1e9:.2f} TFLOP/s) | bound "
          f"{gemm_bound_ms:.4f} ms (2mnk / 67 TFLOP/s) | plain "
          f"{gemm_plain_ms:.4f} ms | torch.matmul (TF32 off) "
          f"{gemm_lib_ms:.4f} ms")
    del a, b

    triad_ms = {}
    for label, n_bytes in TRIAD_SIZES.items():
        n_ = triad_length(n_bytes)
        x, y = randn(n_), randn(n_)
        worst = check_close(f"triad {label} n={n_} f32", triad(x, y, gamma=3.0),
                            triad_ref(x, y, 3.0), triad_tol(torch.float32))
        errs["triad"] = max(errs["triad"], worst)
        n_checks["triad"] += 1
        print(f"triad {label} n={n_} f32: ok, max abs err {worst:.3e}")
        moved = 3.0 * n_ * 4
        iters = 200 if label == "cache" else 50
        triad_ms[label] = {
            "n": n_, "moved": moved,
            "kernel": cuda_ms(lambda: triad(x, y, gamma=3.0), iters),
            "graph": graph_ms(lambda: triad(x, y, gamma=3.0)),
            "plain": cuda_ms(lambda: triad_ref(x, y, 3.0), iters),
            "library": cuda_ms(lambda: torch.add(x, y, alpha=3.0), iters),
            "bound": max(moved / HBM_PEAK, 2.0 * n_ / F32_PEAK) * 1e3,
        }
        t = triad_ms[label]
        print(f"triad {label} ({n_bytes >> 20} MiB, n={n_}) f32: kernel "
              f"{t['kernel']:.5f} ms ({moved / t['kernel'] / 1e9:.3f} TB/s)"
              f", graph replay {t['graph']:.5f} ms "
              f"({moved / t['graph'] / 1e9:.3f} TB/s) | bound "
              f"{t['bound']:.5f} ms (3n*4 B / 3.35 TB/s) | plain "
              f"{t['plain']:.5f} ms | torch.add(alpha=3) "
              f"{t['library']:.5f} ms")
        del x, y
    # One tuner sample at a size the card finishes in ~2 us: host time =
    # the wrapper's dispatch + the kernel + the sampler's synchronize.
    x, y = randn(1024), randn(1024)
    c = torch.empty_like(x)
    launcher = build.kernel_fn("rt_triad_f32", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
    ptrs = (x.data_ptr(), y.data_ptr(), c.data_ptr(), x.numel(), 3.0, 0,
            build.current_stream_ptr(0))
    dispatch = {
        "triad wrapper": host_us_per_call(lambda: triad(x, y, gamma=3.0)),
        "ctypes launch alone": host_us_per_call(lambda: launcher(*ptrs)),
        "torch.add(alpha=3)": host_us_per_call(
            lambda: torch.add(x, y, alpha=3.0)),
    }
    sample_us = host_us_per_sample(lambda: triad(x, y, gamma=3.0))
    device_us = graph_ms(lambda: triad(x, y, gamma=3.0)) * 1e3
    wrapper_us = dispatch["triad wrapper"]
    print("dispatch at n=1024 (host us/call, back to back): " + " | ".join(
        f"{name} {us:.2f}" for name, us in dispatch.items()))
    print(f"one tuner sample at n=1024 (host us, median): {sample_us:.2f} = "
          f"wrapper {wrapper_us:.2f} + kernel {device_us:.2f} (graph "
          f"replay) + synchronize and the rest "
          f"{sample_us - wrapper_us - device_us:.2f}")
    del x, y, c
    torch.cuda.empty_cache()

    # -- 5. main path ------------------------------------------------------
    phase("main path")
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    kernels.reset_launch_counts()
    launches = {"matmul": 0, "triad": 0}
    t_main = time.perf_counter()
    runs = {}
    for args in (["--benchmark", "triad", "--full"],
                 ["--benchmark", "dgemm", "--full", "--strategy", "random",
                  "--budget", str(roofline_model.CARD_DGEMM_BUDGET),
                  "--seed", "0"],
                 ["--benchmark", "gemm_tiled", "--report"]):
        out, counts = run_tune(args)
        runs[args[1]] = (out, counts)
        for key in launches:
            launches[key] += counts.get(key, 0)
    if "peak compute F_p (dgemm)" not in runs["gemm_tiled"][0]:
        fail("gemm_tiled --report rendered no roofline")

    print("$ repro_torch.bench.roofline_model (cache 4 MiB, dram 256 MiB)",
          flush=True)
    t0 = time.perf_counter()
    res = roofline_model.run(quick=True, cache_dir=str(WORK / "roofline"))
    print(f"  roofline-model wall {time.perf_counter() - t0:.1f}s")
    in_process = kernels.launch_counts()
    for key in launches:
        launches[key] += in_process[key]
    main_wall = time.perf_counter() - t_main
    report = next((r for r in res["reports"]
                   if r.fingerprint == res["fingerprint"]), None)
    if report is None:
        fail("roofline model: no report for this card's fingerprint")
    if "peak compute F_p (dgemm)" not in res["markdown"]:
        fail("roofline model: no DGEMM F_p in the rendered roofline")
    if len(report.bandwidths) < 2:
        fail(f"roofline model: {len(report.bandwidths)} TRIAD subsystem(s), "
             f"want at least 2")
    peaks = [report.dgemm.score] + [inc.score for _, inc in report.bandwidths]
    if not all(math.isfinite(p) and p > 0 for p in peaks):
        fail(f"roofline model: non-finite or non-positive peaks {peaks}")
    print(f"roofline: F_p {report.dgemm.score:.1f} GFLOP/s "
          f"({report.dgemm.config}); "
          + "; ".join(f"B_a {name} {inc.score:.1f} GB/s"
                      for name, inc in report.bandwidths))
    m = re.search(r"^best      : .*score=([0-9.eE+-]+)$", runs["dgemm"][0],
                  re.M)
    ratio = report.dgemm.score / float(m.group(1))
    print(f"roofline F_p / dgemm --full F_p = {ratio:.3f} (must lie in "
          f"{F_P_AGREEMENT})")
    if not F_P_AGREEMENT[0] <= ratio <= F_P_AGREEMENT[1]:
        fail(f"roofline model F_p {report.dgemm.score:.1f} is {ratio:.3f}x "
             f"the dgemm --full session's {m.group(1)}")
    print(f"main path: search wall {main_wall:.1f}s; launches {launches}")
    for key in ("triad", "matmul"):
        if launches[key] == 0:
            fail(f"the main path never launched the {key} kernel")
    if runs["triad"][1]["triad"] == 0:
        fail("tune --benchmark triad launched no TRIAD kernel")
    if runs["gemm_tiled"][1]["matmul"] == 0:
        fail("tune --benchmark gemm_tiled launched no GEMM kernel")
    by_size = {name: inc.score for name, inc in report.bandwidths}
    for label, n_bytes in TRIAD_SIZES.items():
        name = f"mem[{n_bytes >> 20}MiB]"
        t = triad_ms[label]
        event_gbs = t["moved"] / t["kernel"] / 1e6
        graph_gbs = t["moved"] / t["graph"] / 1e6
        host = by_size[name]
        print(f"triad {name}: tuner host-clock {host:.1f} GB/s vs "
              f"CUDA-event {event_gbs:.1f} GB/s (host/event "
              f"{host / event_gbs:.3f}), graph replay {graph_gbs:.1f} GB/s")

    # -- result lines ------------------------------------------------------
    phase("result")
    print(f"total wall {time.perf_counter() - t_start:.1f}s")
    print(card_line())
    t_dram = triad_ms["dram"]
    print(json.dumps({"kernels": [
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul/matmul.py:27",
         "launches": launches["matmul"], "max_abs_err": errs["matmul"],
         "ms": gemm_ms, "plain_ms": gemm_plain_ms,
         "bound_ms": gemm_bound_ms, "bound_by": "operations",
         "library_ms": gemm_lib_ms, "checks_passed": n_checks["matmul"],
         "shape": list(GEMM_MAIN), "tile": list(best_tile),
         "dtype": "float32"},
        {"name": "triad", "route": "cuda",
         "source": "src/repro_torch/csrc/triad.cu",
         "replaces": "src/repro/kernels/triad/triad.py:26",
         "launches": launches["triad"], "max_abs_err": errs["triad"],
         "ms": t_dram["kernel"], "plain_ms": t_dram["plain"],
         "bound_ms": t_dram["bound"], "bound_by": "bytes",
         "library_ms": t_dram["library"], "checks_passed": n_checks["triad"],
         "n": t_dram["n"], "dtype": "float32"},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
