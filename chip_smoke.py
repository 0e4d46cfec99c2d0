#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout: the kernels are built from
``src/repro_torch/csrc`` at first use. Phases, each of which fails the
run when it fails:

1. card      — ``nvidia-smi`` name and power limit; torch, CUDA, nvcc.
2. build     — compile the CUDA kernels for sm_90a; print the seconds,
               every kernel's registers, spills and static shared memory,
               the kernels that spill, and the dynamic shared memory of
               the GEMM, flash (both kernels, every bf16 tile) and SSD
               blocks; the library's bf16 flash tile table must be the
               wrapper's.
3. checks    — each kernel against its plain PyTorch version on the card:
               GEMM at every tile of the table at 4096x2048x6144 f32 and
               at 300x450x200 and 1024x256x128 in f32 and bf16; TRIAD at
               n in {1024, 2**20 + 17, 2**26} in f32 and bf16 (plus an
               unaligned view that takes the scalar path), and at every
               length of the ``triad --full`` ladder in f32; flash
               attention on the cases of ``tests/test_kernels.py`` and
               at every head dim the configs use, each at every (bq, bk)
               of the full model-step space (bf16 on the tensor-core
               kernel, which must run every compiled physical tile; f32
               on the CUDA cores), then at the model step's
               shape (B=1, H=32, Hkv=8, S=4096, D=64, causal) at each
               tile of the quick space, in bf16 and in f32 within
               FLASH_MAIN_TOL, and its
               autograd gradients against the plain version's (exact:
               the backward is the plain math); the SSD chunk scan's y
               and final state on SSD_CASES (the cases of
               ``tests/test_kernel_ssd.py``, an odd chunk, mamba2-130m's
               widths at Q in {128, 256, 512} and zamba2-2.7b's) within
               SSD_ULPS f32 ulps of the largest element, and its autograd
               gradients (exact).
4. timing    — CUDA-event times of each kernel at the main path's shapes
               (each checked against its plain version on the same
               tensors first) beside its bound, its plain version and one
               PyTorch call that computes the same function; TRIAD also
               replayed from a CUDA graph (device time without the host's
               dispatch); the host cost of one tuner sample at
               n = 1024, split into the wrapper's dispatch and the
               sampler's synchronize; the flash kernel at each quick tile
               beside scaled_dot_product_attention, its f32 route, and
               zamba2-2.7b's D = 80 at each quick tile (checked first);
               attention forward + backward at
               the model step's shape on the flash and plain paths; the
               SSD kernel at SSD_MAIN (mamba2-130m serving, zamba2-2.7b
               train), checked first, beside its bound and its plain
               version (no PyTorch call computes it).
5. main path — ``python -m repro_torch.tune`` for ``triad --full``,
               ``dgemm --full --strategy random --budget 16 --seed 0`` and
               ``gemm_tiled --report``, then the roofline-model bench with
               its cache (4 MiB) and DRAM (256 MiB) TRIAD sizes, which on
               a card tunes DGEMM over the same 16 random configs of the
               full space as the ``dgemm --full`` session; gemm_tiled
               must tune all 12 tiles; the
               rendered roofline must hold a DGEMM F_p within
               F_P_AGREEMENT of the ``dgemm --full`` session's and at
               least two TRIAD subsystems, and both kernels must have
               launched.
6. model step — the tuner over ``model_step_space(quick=True)`` (8
               configs) on ``model_step_family("train_step")`` in
               process, with a fresh cache dir: granite-3-2b at full
               width (d_model 2048, 32 heads, 8 kv heads, d_ff 8192,
               vocab 49155, bf16), depth cut from 40 to 4 layers, B=1,
               S=4096 (the ``train_4k`` sequence). All 8 trials, a finite
               best score and flash launches, all on the tensor-core
               kernel, are required, and the
               4-layer loss with ``use_flash=1`` must match
               ``use_flash=0`` on the same weights within
               MODEL_STEP["loss_rtol"]; then the same in float32 (the
               f32 flash kernel, one launch a layer) within
               MODEL_STEP["f32_loss_rtol"].
7. full depth — one granite-3-2b train step at all 40 layers, B=1,
               S=4096, ``use_flash=1`` at the tuner's best flash tiles:
               loss and gradients finite; step time and peak memory.
8. serving   — mamba2-130m at full width and depth (SERVING): one
               ``api.prefill_fn`` of 4 prompts of 32768 tokens (one SSD
               launch per layer required, finite logits), then 32 greedy
               ``api.decode_fn`` steps (tokens in the vocabulary); prefill
               ms, decode ms per step, peak memory. Then, in f32 at the
               same widths, a 4096-token prefill and 256 teacher-forced
               decode steps must give the logits and states of one
               4352-token prefill within CONTINUE_TOL.
9. hybrid    — as phase 6 on zamba2-2.7b's train step (HYBRID_STEP: full
               width, depth cut from 54 to 6 layers, B=1, S=4096): every
               config must launch the SSD kernel, and the flash kernel
               exactly when ``use_flash=1`` (head dim 80); then CUDA-event
               times of one layer's parts alone, and a ``torch.profiler``
               trace of one step at the tuner's flash tile: the device's
               idle share of the step, and the device time of the SSD
               kernel, the flash kernel, their plain backward passes and
               the rest.

Each phase prints its seconds.

The last three lines are the card line, one ``{"kernels": [...]}`` JSON
object (flash attention split by route: ``flash_attention`` the bf16
tensor-core kernel, ``flash_attention_f32`` the CUDA-core one) and
``{"ok": true, "device": {...}}``. Without a card, or outside
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
BF16_PEAK = 989e12                         # tensor cores, bf16, dense
SMEM_PER_SM = 228 * 1024                   # H100: shared memory per SM
SUBPROCESS_TIMEOUT_S = 420
FLASH_MAIN = (1, 32, 8, 4096, 64)          # (B, H, Hkv, S, D), granite-3-2b
FLASH_TOL = {"f32": {"rtol": 2e-5, "atol": 2e-5},   # tests/test_kernels.py
             "bf16": {"rtol": 3e-2, "atol": 3e-2}}
# At FLASH_MAIN an output element of unit-normal q, k, v is about 0.03, as
# large as the test tolerance above, so the main shape gets limits from the
# rounding instead: the plain version computes in f32 and rounds once to
# bf16; the tensor-core kernel also rounds P to bf16 before P V (its max
# abs error there reads 7.8e-3 to 1.6e-2 on an H100, by the seeded draw,
# against 1.95e-3 for the CUDA-core kernel, PERF.md), within two bf16 ulps
# (2**-8 relative; rtol 1.6e-2) plus atol 4e-3; f32 orders its sums differently only. A kv sub-tile dropped or
# misweighted at long S moves outputs by ~1e-3.
FLASH_MAIN_TOL = {"f32": {"rtol": 1e-5, "atol": 1e-5},
                  "bf16": {"rtol": 1.6e-2, "atol": 4e-3}}
#: (b, hq, hkv, s, d, causal, window, dtype): the flash cases of
#: tests/test_kernels.py (GQA x causal, windows, padded lengths, bf16),
#: the padded non-causal case, and the head dims the configs use
FLASH_CASES = (
    [(2, hq, hkv, 256, 64, causal, None, "f32")
     for hq, hkv in ((8, 8), (8, 2), (8, 1)) for causal in (True, False)]
    + [(1, 4, 2, 256, 32, True, w, "f32") for w in (32, 96, 256)]
    + [(1, 4, 4, s, 32, True, None, "f32") for s in (100, 200, 250)]
    + [(1, 4, 2, s, 32, False, None, "f32") for s in (100, 200, 250)]
    + [(1, 4, 4, 128, 64, True, None, "bf16")]
    + [(1, 4, 2, 300, d, True, None, dt) for d in (16, 128)
       for dt in ("f32", "bf16")]
    + [(1, 2, 1, 300, 256, True, 64, dt) for dt in ("f32", "bf16")]
    + [(1, 4, 4, 300, 80, True, 96, dt) for dt in ("f32", "bf16")]
    + [(1, 4, 2, 300, 32, True, 96, "bf16"),
       (2, 8, 2, 256, 64, False, None, "bf16")])
# In float32 the flash kernel (CUDA cores) and the plain attention differ by
# the order of their f32 sums only (1e-6 relative per element at most at
# the main shape, FLASH_MAIN_TOL); through 4 layers that is far below the
# limit, which a kernel wrong in one layer or a share of rows exceeds.
F32_LOSS_RTOL = 1e-5
# The flash and plain attention outputs are each rounded to bf16, and the
# tensor-core kernel rounds P to bf16 too, so they differ by about one bf16
# ulp (2**-8 relative) in some elements; through 4 random-weight layers
# that moves the loss by 6.7e-6 to 1.1e-5 relative on an H100 (by the kv
# tile, PERF.md). A kernel wrong in one layer or a share of rows moves it
# by more than the limit.
MODEL_STEP = {"arch": "granite_3_2b", "layers": 4, "batch": 1, "seq": 4096,
              "loss_rtol": 1e-4, "f32_loss_rtol": F32_LOSS_RTOL}
#: zamba2-2.7b's train step: full width, depth cut from 54 layers to one
#: group of attn_every = 6 Mamba2 layers and one use of the shared block.
#: Its one flash layer moves the loss by 3.8e-6 to 5.0e-6 relative on an
#: H100 with the tensor-core kernel (by the kv tile; 1.14e-6 with the
#: CUDA-core kernel, PERF.md); the limit is twice that.
HYBRID_STEP = {"arch": "zamba2_2_7b", "layers": 6, "batch": 1, "seq": 4096,
               "loss_rtol": 1e-5}
#: mamba2-130m serving: full width and depth, the prefill_32k prompt
#: length at batch 4 (its global batch of 32 is a multi-chip deployment's)
SERVING = {"arch": "mamba2_130m", "batch": 4, "seq": 32768,
           "decode_steps": 32}
#: decode continuing prefill, in f32 at the same widths: a 4096-token
#: prefill and 256 teacher-forced decode steps against a 4352-token prefill
CONTINUE = {"prefill": 4096, "decode": 256}
CONTINUE_TOL = {"rtol": 1e-4, "atol": 1e-4}  # tests/test_ssd.py
#: (B, H, C, Q, P, N, with h0): the cases of tests/test_kernel_ssd.py (its
#: four shapes and the state-carry case), an odd chunk (S = 300, Q = 100),
#: mamba2-130m's widths at S = 4096 with Q in {128, 256, 512} (the config's
#: chunk and the knob space of src/repro/launch/perf.py:73) and zamba2-2.7b's
SSD_CASES = (
    [(2, 3, 4, 16, 8, 16, False), (2, 3, 4, 32, 16, 8, False),
     (1, 8, 2, 16, 8, 16, False), (2, 3, 8, 8, 8, 16, False),
     (1, 1, 3, 8, 4, 4, False), (1, 1, 3, 8, 4, 4, True),
     (1, 24, 3, 100, 64, 128, True)]
    + [(1, 24, 4096 // q, q, 64, 128, False) for q in (128, 256, 512)]
    + [(1, 80, 32, 128, 64, 64, False)])
#: the main path's shapes (B, H, C, Q, P, N): mamba2-130m serving and
#: zamba2-2.7b's train step
SSD_MAIN = {"mamba2 serving": (4, 24, 128, 256, 64, 128),
            "zamba2 train": (1, 80, 32, 128, 64, 64)}
# The kernel and the plain version both compute in f32 and differ by the
# order of their sums only: the limit is SSD_ULPS f32 ulps (2**-23) of the
# largest output element, per element, far below the reference tests' 2e-5
# times that magnitude; on an H100 the error reads under 3 such ulps
# (PERF.md). A dropped or misplaced 64-position sub-tile moves outputs by
# O(0.1) or more.
SSD_ULPS = 8
# The roofline model and the ``dgemm --full`` session time the same random
# configs with the same sampler, so their F_p differ by run-to-run noise
# and the model's smaller per-config budget only.
F_P_AGREEMENT = (0.8, 1.25)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


_PHASE: dict = {}


def phase(name: str) -> None:
    """Start a phase; print the seconds the previous one took."""
    now = time.perf_counter()
    if _PHASE:
        print(f"-- {_PHASE['name']}: {now - _PHASE['t0']:.1f}s", flush=True)
    _PHASE.update(name=name, t0=now)
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


def kernel_label(mangled: str) -> str:
    """``name<dtype,dims...>`` of a mangled ``*_kernel`` function, a
    template instantiation or not (the identifier is the one its length
    prefix spans; namespaces before it may hold digits)."""
    m = re.search(r"_kernel[IE]", mangled)
    if m is None:
        return mangled
    end = m.start() + len("_kernel")
    base = next((mangled[m.end():end]
                 for m in re.finditer(r"\d+", mangled[:end])
                 for i in range(len(m.group()))
                 if int(m.group()[i:]) == end - m.end()), mangled[:end])
    rest = mangled[end:]
    dims = "".join(f",{d}" for d in re.findall(r"Li(\d+)E", rest))
    return f"{base}<{'bf16' if 'bfloat16' in rest else 'f32'}{dims}>"


def ptxas_report(log_text: str) -> list[str]:
    """One line per compiled kernel instantiation of the build log:
    registers, spill stores and loads, static shared memory."""
    rows, name, spills = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and "spill stores" in line:
            spills = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            label = kernel_label(name)
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append(f"{label}: {m.group(1)} registers, {spills or '?'}, "
                        f"{smem.group(1) if smem else 0} bytes static smem")
            name, spills = None, ""
    return rows


def tree_leaves(tree: dict) -> list:
    return [x for v in tree.values()
            for x in (tree_leaves(v) if isinstance(v, dict) else [v])]


def launch_checked(wrapper, call):
    """``call()``, which must launch ``wrapper``'s kernel exactly once."""
    import torch
    before = wrapper.launches
    got = call()
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        fail(f"{wrapper.__name__}: launch counter did not move")
    return got


def flash_case_checks(randn) -> tuple[int, float]:
    """The flash kernels against ``attention_ref`` on every case of
    FLASH_CASES, each at every (bq, bk) of the full model-step space: the
    bf16 cases on the tensor-core kernel, which must have run every
    compiled physical tile of every head dim, the f32 cases on the CUDA
    cores. Returns (checks, max abs err over the f32 cases)."""
    import torch
    from repro_torch.bench.common import model_step_space
    from repro_torch.kernels.flash_attention import (SM90_TILES,
                                                     attention_ref,
                                                     flash_attention,
                                                     padded_blocks,
                                                     physical_tile)
    tiles = sorted({(c["flash_block_q"], c["flash_block_k"])
                    for c in model_step_space(False).configs()})
    ran = {d: set() for d in SM90_TILES}   # physical tiles run, bf16
    checks, worst_f32 = 0, 0.0
    for b, hq, hkv, s, d, causal, window, dt in FLASH_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q, k, v = (randn(b, h, s, d, dtype=dtype) for h in (hq, hkv, hkv))
        want = attention_ref(q, k, v, causal=causal, window=window)
        label = (f"flash b={b} h={hq}/{hkv} s={s} d={d} causal={causal} "
                 f"window={window} {dt}")
        route = "tensor_cores" if dt == "bf16" else "cuda_cores"
        worst = 0.0
        for bq, bk in tiles:
            routed = flash_attention.route_launches[route]
            got = launch_checked(flash_attention, lambda: flash_attention(
                q, k, v, causal=causal, window=window, bq=bq, bk=bk))
            if flash_attention.route_launches[route] != routed + 1:
                fail(f"{label}: the {route} kernel did not launch")
            worst = max(worst, check_close(f"{label} tile ({bq}, {bk})", got,
                                           want, FLASH_TOL[dt]))
            checks += 1
            if dt == "bf16":
                bq_, bk_, _ = padded_blocks(s, bq, bk)
                ran[d].add(physical_tile(bq_, bk_, SM90_TILES[d]))
        if dt == "f32":
            worst_f32 = max(worst_f32, worst)
        print(f"{label}: {len(tiles)} tiles ok, max abs err {worst:.3e}")
    for d, compiled in SM90_TILES.items():
        if ran[d] != set(compiled):
            fail(f"flash bf16 d={d}: the cases ran physical tiles "
                 f"{sorted(ran[d])}, not every compiled one {compiled}")
    print(f"flash bf16: every compiled (head dim, physical tile) checked: "
          f"{sum(map(len, ran.values()))} kernels")
    return checks, worst_f32


def flash_main_checks(q, k, v, g, tiles) -> tuple[int, dict]:
    """The flash kernel at the model step's shape at each quick tile, on
    the bf16 operands and on their f32 copies, and its autograd gradients
    against the plain version's (exact: the backward recomputes through
    the plain math). Returns (checks, max abs err per dtype)."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    worst = {}
    for dt, (q_, k_, v_) in (("bf16", (q, k, v)),
                             ("f32", (x.float() for x in (q, k, v)))):
        want = attention_ref(q_, k_, v_, causal=True)
        worst[dt] = 0.0
        for bq, bk in tiles:
            got = launch_checked(flash_attention, lambda: flash_attention(
                q_, k_, v_, causal=True, bq=bq, bk=bk))
            worst[dt] = max(worst[dt], check_close(
                f"flash {FLASH_MAIN} {dt} tile ({bq}, {bk})", got, want,
                FLASH_MAIN_TOL[dt]))
        print(f"flash {FLASH_MAIN} {dt} causal: {len(tiles)} tiles ok, max "
              f"abs err {worst[dt]:.3e} (tol {FLASH_MAIN_TOL[dt]})")
        del q_, k_, v_, want, got
        torch.cuda.empty_cache()
    grads = {}
    for name, fn in (("kernel", lambda *x: launch_checked(
            flash_attention, lambda: flash_attention(*x, bq=tiles[0][0],
                                                     bk=tiles[0][1]))),
                     ("plain", lambda *x: attention_ref(*x))):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        grads[name] = torch.autograd.grad(fn(*leaves), leaves, g)
    for name, a, b in zip("qkv", grads["kernel"], grads["plain"]):
        if not torch.equal(a, b):
            fail(f"flash d{name}: the autograd function's gradient differs "
                 f"from the plain version's (max abs err "
                 f"{float((a.float() - b.float()).abs().max()):.3e})")
    print(f"flash {FLASH_MAIN} bf16: dq, dk, dv equal the plain version's "
          f"exactly")
    return 2 * len(tiles), worst


def counting(bench, per_config: dict):
    """``bench`` with each config's kernel launches during its samples
    added up in ``per_config[config key]`` (pre-heat calls excluded)."""
    from collections import Counter
    from repro_torch import kernels

    def wrapped(cfg: dict):
        factory = bench(cfg)
        counts = per_config.setdefault(tuple(sorted(cfg.items())), Counter())

        def counted_factory():
            sampler = factory()

            def sample():
                before = kernels.launch_counts()
                out = sampler()
                for name, n in kernels.launch_counts().items():
                    counts[name] += n - before[name]
                return out
            return sample
        return counted_factory

    wrapped.precompile = bench.precompile
    wrapped.__name__ = bench.__name__
    return wrapped


def model_step_path(work: pathlib.Path, spec: dict) -> dict:
    """Tune one model's train step (full width, ``spec``'s depth, batch
    and sequence) over the quick model-step space in process; check the
    session, that every config launched the SSD kernel where the model
    has Mamba2 layers and the flash kernel exactly when ``use_flash=1``,
    and the flash/plain loss agreement within ``spec["loss_rtol"]``.
    Returns what the result line needs."""
    import dataclasses
    import gc
    import statistics
    import torch
    from repro_torch import kernels
    from repro_torch.bench.common import (model_step_family,
                                          model_step_space, paper_settings)
    from repro_torch.configs import get
    from repro_torch.core import Tuner, TuningSession
    from repro_torch.models.transformer import StepConfig
    from repro_torch.models.workloads import build_workload, step_flops
    full = get(spec["arch"])
    cfg = dataclasses.replace(full, n_layers=spec["layers"])
    b, s = spec["batch"], spec["seq"]
    flops = step_flops(cfg, b, s)
    has_ssd = cfg.family in ("ssm", "hybrid")
    widths = (f"d_model {cfg.d_model}, {cfg.n_heads} heads, "
              f"{cfg.n_kv_heads} kv heads, head_dim {cfg.head_dim_}, d_ff "
              f"{cfg.d_ff}")
    if has_ssd:
        widths += (f", d_inner {cfg.d_inner}, {cfg.ssm_heads} SSD heads, "
                   f"ssm_state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
                   f"attn_every {cfg.attn_every}, window {cfg.window}")
    print(f"{full.name} at full width ({widths}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}); depth cut from {full.n_layers} to {cfg.n_layers} "
          f"layers ({cfg.n_params() / 1e6:.1f}M params); B={b}, S={s}; "
          f"work term {flops / 1e12:.4f} TFLOP per step (FlopCounterMode, "
          f"plain path)")
    settings = dataclasses.replace(paper_settings(True),
                                   use_ci_convergence=True,
                                   use_inner_prune=True,
                                   use_outer_prune=True)
    per_config: dict = {}
    session = TuningSession(
        f"model_step_{spec['arch']}", Tuner(model_step_space(True), settings),
        counting(model_step_family("train_step", cfg, batch_size=b,
                                   seq_len=s), per_config),
        cache_dir=str(work / f"model_step_{spec['arch']}"),
        benchmark_name="train_step")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = session.run()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    routes = dict(kernels.flash_attention.route_launches)
    del session
    if len(result.trials) != 8:
        fail(f"model step: {len(result.trials)} trials recorded, want 8")
    if result.best_score is None or not math.isfinite(result.best_score):
        fail(f"model step: best score {result.best_score}")
    step_ms = {}
    for t in result.trials:
        r = t.result
        rate = statistics.median(inv.mean for inv in r.invocations)
        key = (t.config["use_flash"], t.config["flash_block_q"],
               t.config["flash_block_k"])
        step_ms[key] = flops / (rate * 1e9) * 1e3
        counts = per_config[tuple(sorted(t.config.items()))]
        print(f"  {t.config} -> {r.score:.1f} GFLOP/s, median step "
              f"{step_ms[key]:.2f} ms over {len(r.invocations)} "
              f"invocations, {r.total_samples} samples"
              f"{' (pruned)' if r.pruned else ''} ({r.stop_reason}); "
              f"launches in its samples: flash {counts['flash_attention']}"
              + (f", ssd {counts['ssd_chunk_scan']}" if has_ssd else ""))
        if bool(counts["flash_attention"]) != bool(t.config["use_flash"]):
            fail(f"model step {t.config}: {counts['flash_attention']} flash "
                 f"launches (wanted some exactly when use_flash=1)")
        if has_ssd and counts["ssd_chunk_scan"] == 0:
            fail(f"model step {t.config}: the SSD kernel never launched")
    print(f"model step: best {result.best_config} score "
          f"{result.best_score:.1f} GFLOP/s; session wall {wall:.1f}s; "
          f"launches {launches}; flash per route {routes}")
    if routes != {"tensor_cores": launches["flash_attention"],
                  "cuda_cores": 0}:
        fail(f"model step ({cfg.dtype}): flash launches {routes} did not all "
             f"go through the tensor-core kernel")
    flash = [t for t in result.trials if t.config["use_flash"]]
    best = max(flash, key=lambda t: (not t.result.pruned, t.result.score))
    tile = (best.config["flash_block_q"], best.config["flash_block_k"])
    gc.collect()
    torch.cuda.empty_cache()
    w = build_workload("train_step", cfg, batch_size=b, seq_len=s)
    losses = {}
    for label, step in (("plain", StepConfig(remat=False)),
                        ("flash", StepConfig(use_flash=True,
                                             flash_block_q=tile[0],
                                             flash_block_k=tile[1],
                                             remat=False))):
        losses[label] = float(w.with_step(step).fn(*w.args)[0])
    rel = abs(losses["flash"] / losses["plain"] - 1.0)
    print(f"{cfg.n_layers}-layer loss: use_flash=1 {losses['flash']:.6f} vs "
          f"use_flash=0 {losses['plain']:.6f} (relative {rel:.3e}, tol "
          f"{spec['loss_rtol']})")
    if not (math.isfinite(rel) and rel <= spec["loss_rtol"]):
        fail(f"model step: flash loss {losses['flash']} vs plain "
             f"{losses['plain']}")
    del w
    gc.collect()
    torch.cuda.empty_cache()
    out = {"launches": launches, "routes": routes, "tile": tile,
           "step_ms": step_ms, "best": result.best_config, "wall": wall,
           "loss_rel": rel}
    if "f32_loss_rtol" in spec:
        out.update(f32_loss(cfg, b, s, tile, spec["f32_loss_rtol"]))
    return out


def f32_loss(cfg, b: int, s: int, tile: tuple[int, int], rtol: float
             ) -> dict:
    """The same step in float32 (weights, activations, attention): the
    loss with ``use_flash=1``, which runs the f32 flash kernel on the CUDA
    cores, against ``use_flash=0`` within ``rtol``. Returns the relative
    difference and the f32 kernel's launches in these two steps."""
    import dataclasses
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.models.transformer import StepConfig
    from repro_torch.models.workloads import build_workload
    cfg = dataclasses.replace(cfg, dtype="float32")
    w = build_workload("train_step", cfg, batch_size=b, seq_len=s)
    before = dict(kernels.flash_attention.route_launches)
    losses = {}
    for label, step in (("plain", StepConfig(remat=False)),
                        ("flash", StepConfig(use_flash=True,
                                             flash_block_q=tile[0],
                                             flash_block_k=tile[1],
                                             remat=False))):
        losses[label] = float(w.with_step(step).fn(*w.args)[0])
    torch.cuda.synchronize()
    after = kernels.flash_attention.route_launches
    f32_launches = after["cuda_cores"] - before["cuda_cores"]
    rel = abs(losses["flash"] / losses["plain"] - 1.0)
    print(f"{cfg.n_layers}-layer loss in float32: use_flash=1 "
          f"{losses['flash']:.7f} vs use_flash=0 {losses['plain']:.7f} "
          f"(relative {rel:.3e}, tol {rtol}); f32 flash kernel launches "
          f"{f32_launches}")
    if not (math.isfinite(rel) and rel <= rtol):
        fail(f"model step f32: flash loss {losses['flash']} vs plain "
             f"{losses['plain']}")
    if f32_launches != cfg.n_layers or \
            after["tensor_cores"] != before["tensor_cores"]:
        fail(f"model step f32: flash launches per route went from {before} "
             f"to {dict(after)}, want {cfg.n_layers} on the CUDA cores")
    del w
    gc.collect()
    torch.cuda.empty_cache()
    return {"f32_loss_rel": rel, "f32_launches": f32_launches}


def full_depth_step(tile: tuple[int, int]) -> dict:
    """One granite-3-2b train step at all its layers with the flash
    kernel at ``tile``: finite loss and gradients, step time, peak
    memory. The first step warms up; the second is timed."""
    import torch
    from repro_torch.configs import get
    from repro_torch.models.transformer import StepConfig
    from repro_torch.models.workloads import build_workload
    cfg = get(MODEL_STEP["arch"])
    b, s = MODEL_STEP["batch"], MODEL_STEP["seq"]
    w = build_workload("train_step", cfg, batch_size=b, seq_len=s,
                       step=StepConfig(use_flash=True, flash_block_q=tile[0],
                                       flash_block_k=tile[1], remat=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        loss, grads = w.fn(*w.args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        leaves = tree_leaves(grads)
        if not math.isfinite(float(loss)) or not all(
                bool(torch.isfinite(g).all()) for g in leaves):
            fail(f"full-depth step: non-finite loss {float(loss)} or "
                 f"gradients")
        del grads, leaves
    peak = torch.cuda.max_memory_allocated()
    print(f"{cfg.name}, all {cfg.n_layers} layers ({cfg.n_params() / 1e9:.3f}B "
          f"params), B={b}, S={s}, use_flash=1 tile {tile}: loss "
          f"{float(loss):.6f}; step {times[1] * 1e3:.1f} ms (first "
          f"{times[0] * 1e3:.1f} ms); peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    del w
    torch.cuda.empty_cache()
    return {"step_ms": times[1] * 1e3, "peak_gib": peak / 2 ** 30,
            "loss": float(loss)}


def ssd_inputs(gen, b, h, c, q, p, n, with_h0=False) -> tuple:
    """SSD operands on the card with the reference tests' distributions:
    x * dt, B and C ~ 0.5 N(0, 1), cum the within-chunk cumsum of
    -U(0.01, 0.2), and an optional N(0, 1) initial state."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    xdt, bm, cm = 0.5 * randn(b, h, c, q, p), 0.5 * randn(b, c, q, n), \
        0.5 * randn(b, c, q, n)
    step = 0.01 + 0.19 * torch.rand((b, h, c, q), generator=gen,
                                    device="cuda")
    return (xdt, bm, cm, torch.cumsum(-step, dim=-1),
            randn(b, h, p, n) if with_h0 else None)


def ssd_tol(want) -> dict:
    """Per-element limit: SSD_ULPS f32 ulps of the largest element."""
    return {"rtol": 0.0,
            "atol": SSD_ULPS * 2.0 ** -23 * float(want.abs().max())}


def ssd_check(label: str, ops: tuple) -> tuple[float, float]:
    """The kernel's y and final state against the plain version's on the
    same operands; returns the max abs errors (y, state)."""
    from repro_torch.kernels.ssd import (chunk_scan, ssd_chunk_scan,
                                         ssd_chunk_scan_ref)
    xdt, bm, cm, cum, h0 = ops
    want_y, want_h = ssd_chunk_scan_ref(xdt, bm, cm, cum, h0=h0,
                                        return_state=True)
    got_y, got_h = launch_checked(ssd_chunk_scan, lambda: chunk_scan(
        xdt, bm, cm, cum, h0=h0, return_state=True))
    tol_y, tol_h = ssd_tol(want_y), ssd_tol(want_h)
    err_y = check_close(f"{label} y", got_y, want_y, tol_y)
    err_h = check_close(f"{label} state", got_h, want_h, tol_h)
    print(f"{label}: y max abs err {err_y:.3e} (limit {tol_y['atol']:.3e}, "
          f"max |y| {float(want_y.abs().max()):.3f}); state {err_h:.3e} "
          f"(limit {tol_h['atol']:.3e})")
    return err_y, err_h


def ssd_grad_check(ops: tuple) -> None:
    """The autograd function's gradients against the plain version's
    (exact: the backward recomputes through the plain math)."""
    import torch
    from repro_torch.kernels.ssd import (chunk_scan, ssd_chunk_scan,
                                         ssd_chunk_scan_ref)
    g = torch.randn_like(ops[0])
    grads = {}
    for name, fn in (("kernel", lambda *x: launch_checked(
            ssd_chunk_scan, lambda: chunk_scan(*x))),
                     ("plain", ssd_chunk_scan_ref)):
        leaves = [t.detach().clone().requires_grad_() for t in ops[:4]]
        grads[name] = torch.autograd.grad(fn(*leaves), leaves, g)
    for name, a, b in zip(("xdt", "bm", "cm", "cum"), grads["kernel"],
                          grads["plain"]):
        if not torch.equal(a, b):
            fail(f"ssd d{name}: the autograd function's gradient differs "
                 f"from the plain version's (max abs err "
                 f"{float((a - b).abs().max()):.3e})")
    print(f"ssd {tuple(ops[0].shape)}: dxdt, dB, dC, dcum equal the plain "
          f"version's exactly")


def ssd_shape_cost(shape: tuple) -> dict:
    """Work, bytes and bound of one kernel call at (B, H, C, Q, P, N),
    returning the final state (the prefill path's call). ``flops`` is the
    JAX package's formula, the rate's work term; the bound counts only
    the work the function needs (``needed_flops``: C·Bᵀ once for all
    heads, the causal triangle of the quadratic terms)."""
    from repro_torch.kernels.ssd import bytes_moved, flops, needed_flops
    b, h, c, q, p, n = shape
    work = needed_flops(b, h, c * q, q, p, n)
    moved = bytes_moved(b, h, c * q, q, p, n, return_state=True)
    return {"flops": flops(b, h, c * q, q, p, n), "needed": work,
            "bytes": moved,
            "bound": max(work / F32_PEAK, moved / HBM_PEAK) * 1e3,
            "bound_by": "operations" if work / F32_PEAK >= moved / HBM_PEAK
            else "bytes", "blocks": b * h * -(-p // 32)}


def serving_path() -> dict:
    """mamba2-130m at full width and depth: one prefill of a batch of
    SERVING["batch"] prompts of SERVING["seq"] tokens through
    ``api.prefill_fn``, then greedy decode steps through
    ``api.decode_fn``. Requires one SSD launch per layer in the prefill,
    finite logits and tokens in the vocabulary."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get
    from repro_torch.models import api
    from repro_torch.models.params import materialize
    from repro_torch.models.transformer import StepConfig
    cfg = get(SERVING["arch"])
    b, s, steps = SERVING["batch"], SERVING["seq"], SERVING["decode_steps"]
    params = materialize(torch.Generator(device="cuda").manual_seed(0),
                         api.param_defs(cfg))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s))).cuda()
    step = StepConfig(remat=False)
    print(f"{cfg.name}: all {cfg.n_layers} layers at full width (d_model "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} SSD heads "
          f"of {cfg.ssm_head_dim}, ssm_state {cfg.ssm_state}, chunk "
          f"{cfg.ssm_chunk}, vocab {cfg.vocab_size}, {cfg.dtype}; "
          f"{cfg.n_params() / 1e6:.1f}M params); {b} prompts of {s} tokens "
          f"(cut from prefill_32k's global batch 32), {steps} greedy decode "
          f"steps")
    with torch.no_grad():
        api.prefill_fn(params, {"tokens": tokens[:, :512]}, cfg, step)
        torch.cuda.synchronize()                     # warm-up, not counted
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = api.prefill_fn(params, {"tokens": tokens}, cfg, step)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = kernels.launch_counts()
        if launches["ssd_chunk_scan"] != cfg.n_layers:
            fail(f"serving: {launches['ssd_chunk_scan']} SSD launches in one "
                 f"prefill, want one per layer ({cfg.n_layers})")
        if logits.shape != (b, 1, cfg.vocab_padded) or not bool(
                torch.isfinite(logits).all()):
            fail(f"serving: prefill logits {tuple(logits.shape)}, finite "
                 f"{bool(torch.isfinite(logits).all())}")
        generated = []
        t0 = time.perf_counter()
        for i in range(steps):
            tok = logits[..., :cfg.vocab_size].argmax(dim=-1)   # (B, 1)
            generated.append(tok)
            logits, cache = api.decode_fn(params, {"tokens": tok}, cache,
                                          s + i, cfg, step)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / steps
        gen_tokens = torch.cat(generated, dim=1)
        peak = torch.cuda.max_memory_allocated()
        if not bool(torch.isfinite(logits).all()) or not bool(
                ((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size)).all()):
            fail("serving: non-finite decode logits or tokens outside the "
                 "vocabulary")
        serving_launches = kernels.launch_counts()
    print(f"prefill {prefill_ms:.1f} ms ({b * s / prefill_ms * 1e3:.0f} "
          f"tokens/s); decode {decode_ms:.3f} ms per step of {b} tokens; "
          f"peak memory {peak / 2 ** 30:.2f} GiB; launches {serving_launches}"
          f"; first generated tokens {gen_tokens[:, :8].tolist()}")
    del params, cache, logits
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "peak_gib": peak / 2 ** 30,
            "launches": serving_launches["ssd_chunk_scan"]}


def decode_continues_prefill() -> dict:
    """In f32 at mamba2-130m's widths, B = 1: a CONTINUE["prefill"]-token
    prefill followed by CONTINUE["decode"] teacher-forced decode steps
    must give the last logits and the ssm and conv states of one prefill
    of all the tokens (the kernel's y and final state against the
    sequential recurrence of ``ssd_decode``)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.models import api
    from repro_torch.models.params import materialize
    from repro_torch.models.transformer import StepConfig
    cfg = dataclasses.replace(get(SERVING["arch"]), dtype="float32")
    n0, n1 = CONTINUE["prefill"], CONTINUE["decode"]
    params = materialize(torch.Generator(device="cuda").manual_seed(0),
                         api.param_defs(cfg))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, n0 + n1))).cuda()
    step = StepConfig(remat=False)
    with torch.no_grad():
        logits, cache = api.prefill_fn(params, {"tokens": tokens[:, :n0]},
                                       cfg, step)
        for t in range(n0, n0 + n1):
            logits, cache = api.decode_fn(
                params, {"tokens": tokens[:, t:t + 1]}, cache, t, cfg, step)
        want_logits, want = api.prefill_fn(params, {"tokens": tokens}, cfg,
                                           step)
    errs = {}
    for name, got_t, want_t in (("logits", logits, want_logits),
                                ("ssm", cache["ssm"], want["ssm"]),
                                ("conv", cache["conv"], want["conv"])):
        errs[name] = check_close(f"decode continues prefill: {name}", got_t,
                                 want_t, CONTINUE_TOL)
    print(f"f32 {cfg.name}: prefill {n0} + {n1} decode steps vs prefill "
          f"{n0 + n1}: max abs err logits {errs['logits']:.3e}, ssm states "
          f"{errs['ssm']:.3e}, conv states {errs['conv']:.3e} (limit "
          f"{CONTINUE_TOL})")
    del params, cache, want
    torch.cuda.empty_cache()
    return errs


def hybrid_layer_parts(tile: tuple[int, int]) -> dict:
    """CUDA-event times of the parts of one zamba2-2.7b layer at the
    hybrid step's shape: the SSD kernel's forward and its forward +
    backward (plain recompute), and the shared block's attention forward
    (flash kernel at ``tile``) and forward + backward on the flash and
    the plain paths."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import chunk_scan
    from repro_torch.models.layers import _attend
    cfg = get(HYBRID_STEP["arch"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    ops = ssd_inputs(gen, *SSD_MAIN["zamba2 train"])[:4]
    leaves = [t.detach().clone().requires_grad_() for t in ops]
    g = torch.randn_like(ops[0])
    s = HYBRID_STEP["seq"]
    shape = (HYBRID_STEP["batch"], cfg.n_heads, s, cfg.head_dim_)
    q, k, v, ga = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    kw = dict(causal=True, window=cfg.window)
    with torch.no_grad():
        parts = {
            "ssd_fwd": cuda_ms(lambda: chunk_scan(*ops), iters=10),
            "flash_fwd": cuda_ms(lambda: flash_attention(
                q, k, v, bq=tile[0], bk=tile[1], **kw), iters=5, warmup=1)}
    parts.update({
        "ssd_fwd_bwd": cuda_ms(lambda: torch.autograd.grad(
            chunk_scan(*leaves), leaves, g), iters=3, warmup=1),
        "flash_fwd_bwd": cuda_ms(lambda: torch.autograd.grad(
            flash_attention(*qkv, bq=tile[0], bk=tile[1], **kw), qkv, ga),
            iters=2, warmup=1),
        "plain_attn_fwd_bwd": cuda_ms(lambda: torch.autograd.grad(
            _attend(*qkv, **kw), qkv, ga), iters=2, warmup=1),
    })
    del ops, leaves, g, q, k, v, ga, qkv
    torch.cuda.empty_cache()
    return parts


def step_trace(spec: dict, tile: tuple[int, int]) -> dict:
    """Where one train step's time goes, from a ``torch.profiler`` trace:
    ``spec``'s model at ``use_flash=1`` and ``tile``, one warm-up step,
    two steps timed by the host clock, then one traced step. The device
    is busy for the sum of the traced kernels' times; the rest of the
    host-clock step is device idle time. Device times of the parts: the
    SSD and flash kernels by their names, the plain backward passes of
    both by the kernels launched under their autograd nodes."""
    import dataclasses
    import statistics
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get
    from repro_torch.models.transformer import StepConfig
    from repro_torch.models.workloads import build_workload
    cfg = dataclasses.replace(get(spec["arch"]), n_layers=spec["layers"])
    w = build_workload("train_step", cfg, batch_size=spec["batch"],
                       seq_len=spec["seq"],
                       step=StepConfig(use_flash=True, flash_block_q=tile[0],
                                       flash_block_k=tile[1], remat=False))
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        w.fn(*w.args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.mean(walls[1:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        w.fn(*w.args)
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t0) * 1e3
    del w
    torch.cuda.empty_cache()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    if not device:
        fail("step trace: torch.profiler recorded no device activity")

    def named(*tags) -> float:
        return sum(e.time_range.elapsed_us() for e in device
                   if any(t in e.name for t in tags)) / 1e3

    def under(tag: str) -> float:
        total = 0.0
        for e in events:
            if e.device_type != DeviceType.CPU or tag not in e.name:
                continue
            parent = e.cpu_parent
            while parent is not None and tag not in parent.name:
                parent = parent.cpu_parent
            if parent is None:          # outermost event of this node
                total += e.device_time_total
        return total / 1e3

    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    parts = {"ssd kernel": named("ssd_scores_kernel",
                                 "ssd_chunk_scan_kernel"),
             "ssd plain backward": under("_ChunkScanBackward"),
             "flash kernel": named("flash_attention_kernel",
                                   "flash_attention_sm90_kernel"),
             "attention plain backward": under("_FlashAttentionBackward")}
    parts["rest"] = busy - sum(parts.values())
    print(f"{cfg.name}, {cfg.n_layers} layers, use_flash=1 tile {tile}: "
          f"step {wall:.2f} ms by the host clock (steps "
          f"{', '.join(f'{x:.2f}' for x in walls)} ms, the first warming "
          f"up; the traced one {traced_wall:.2f} ms); {len(device)} device "
          f"events busy for {busy:.2f} ms, so the device idles "
          f"{1 - busy / wall:.1%} of the step")
    for name, ms in parts.items():
        print(f"  {name}: {ms:.3f} ms of device time = {ms / busy:.1%} of "
              f"the busy time, {ms / wall:.1%} of the step")
    if parts["ssd kernel"] <= 0 or parts["flash kernel"] <= 0:
        fail(f"step trace: the hand kernels' device time is missing "
             f"({parts})")
    return {"wall_ms": wall, "busy_ms": busy, "parts": parts}


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
    from repro_torch.kernels.matmul import smem_bytes as gemm_smem_bytes
    from repro_torch.kernels.flash_attention import (SM90_TILES,
                                                     attention_ref,
                                                     bytes_moved,
                                                     flash_attention,
                                                     sm90_smem_bytes)
    from repro_torch.kernels.flash_attention import flops as flash_flops
    from repro_torch.kernels.flash_attention import \
        smem_bytes as flash_smem_bytes
    from repro_torch.kernels.triad import triad, triad_ref
    from repro_torch.bench.common import model_step_space
    from repro_torch.kernels.ssd import chunk_scan, ssd_chunk_scan_ref
    from repro_torch.kernels.ssd import smem_bytes as ssd_smem_bytes
    from repro_torch.models.layers import _attend

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
    ptxas_rows = []
    if log.exists():
        text = log.read_text(encoding="utf-8")
        print("  " + text.splitlines()[0])
        ptxas_rows = ptxas_report(text)
        for row in ptxas_rows:
            print("  " + row)
    limit = getattr(torch.cuda.get_device_properties(0),
                    "shared_memory_per_block_optin", "not reported")
    spills = [row for row in ptxas_rows
              if not re.search(r", 0 bytes spill stores", row)]
    print(f"  kernels that spill: {spills or 'none'}")
    for d in sorted({case[4] for case in FLASH_CASES}):
        print(f"  flash f32 d={d}: {flash_smem_bytes(d)} bytes dynamic "
              f"shared memory per block (opt-in limit {limit})")
    table = (ctypes.c_int * 300)()
    n_tiles = build.library().rt_flash_attention_sm90_tiles(table, 100)
    compiled = {tuple(table[3 * i:3 * i + 3]) for i in range(n_tiles)}
    if compiled != {(d, qt, kt) for d, tiles in SM90_TILES.items()
                    for qt, kt in tiles}:
        fail(f"the library's bf16 flash tiles {sorted(compiled)} are not "
             f"the wrapper's SM90_TILES")
    for d, tiles in SM90_TILES.items():
        print(f"  flash bf16 d={d}: dynamic shared memory per block " + ", ".join(
            f"{qt}x{kt} {sm90_smem_bytes(d, qt, kt)}" for qt, kt in tiles))
    print("  matmul f32: dynamic shared memory per block " + ", ".join(
        f"{'x'.join(map(str, t))} {gemm_smem_bytes(*t)}" for t in TILES))
    regs = next((int(m.group(1)) for m in (re.search(
        r"^ssd_chunk_scan_kernel<f32>: (\d+) registers", row)
        for row in ptxas_rows) if m), None)
    for n_state in (64, 128, 256):
        smem = ssd_smem_bytes(n_state)
        # an SM holds 65536 registers and 228 KiB of shared memory, 1 KiB
        # of it reserved per block
        per_sm = "not known" if regs is None else min(
            65536 // (regs * 256), SMEM_PER_SM // (smem + 1024))
        print(f"  ssd N={n_state}: {smem} bytes dynamic shared memory per "
              f"block; {per_sm} scan blocks per SM")

    # -- 3. checks ---------------------------------------------------------
    phase("kernel checks")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev).to(dtype)

    errs = {"matmul": 0.0, "triad": 0.0}
    n_checks = {"matmul": 0, "triad": 0, "flash_attention": 0,
                "ssd_chunk_scan": 0}
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
    n_checks["flash_attention"], errs["flash_f32_cases"] = \
        flash_case_checks(randn)
    quick_tiles = sorted({(c["flash_block_q"], c["flash_block_k"])
                          for c in model_step_space(True).configs()})
    fb, fh, fhkv, fs, fd = FLASH_MAIN
    fq = randn(fb, fh, fs, fd, dtype=torch.bfloat16)
    fk = randn(fb, fhkv, fs, fd, dtype=torch.bfloat16)
    fv = randn(fb, fhkv, fs, fd, dtype=torch.bfloat16)
    fg = randn(fb, fh, fs, fd, dtype=torch.bfloat16)
    n_main, main_errs = flash_main_checks(fq, fk, fv, fg, quick_tiles)
    errs["flash_attention"] = main_errs["bf16"]
    errs["flash_f32_main"] = main_errs["f32"]
    n_checks["flash_attention"] += n_main
    torch.cuda.empty_cache()
    ssd_gen = torch.Generator(device="cuda").manual_seed(3)
    errs["ssd_y"], errs["ssd_state"] = 0.0, 0.0
    for b_, h_, c_, q_, p_, n_, with_h0 in SSD_CASES:
        ops = ssd_inputs(ssd_gen, b_, h_, c_, q_, p_, n_, with_h0)
        ey, eh = ssd_check(f"ssd B={b_} H={h_} S={c_ * q_} Q={q_} P={p_} "
                           f"N={n_}{' h0' if with_h0 else ''}", ops)
        errs["ssd_y"], errs["ssd_state"] = (max(errs["ssd_y"], ey),
                                            max(errs["ssd_state"], eh))
        n_checks["ssd_chunk_scan"] += 1
    ssd_grad_check(ssd_inputs(ssd_gen, *SSD_MAIN["zamba2 train"]))
    n_checks["ssd_chunk_scan"] += 1
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
    flash_ms = {tile: cuda_ms(lambda t=tile: flash_attention(
        fq, fk, fv, causal=True, bq=t[0], bk=t[1]), iters=5, warmup=1)
        for tile in quick_tiles}
    flash_tile = min(flash_ms, key=flash_ms.get)
    flash = {
        "kernel": flash_ms[flash_tile],
        "plain": cuda_ms(lambda: attention_ref(fq, fk, fv, causal=True),
                         iters=3, warmup=1),
        "library": cuda_ms(lambda: torch.nn.functional
                           .scaled_dot_product_attention(
                               fq, fk, fv, is_causal=True, enable_gqa=True),
                           iters=20),
        "flops": flash_flops(fb, fh, fs, fd, True),
        "bytes": bytes_moved(fq, fk),
    }
    flash["bound"] = max(flash["flops"] / BF16_PEAK,
                         flash["bytes"] / HBM_PEAK) * 1e3
    for tile, ms in flash_ms.items():
        print(f"flash tile {tile}: {ms:.4f} ms  "
              f"{flash['flops'] / ms / 1e9:.2f} TFLOP/s")
    print(f"flash {FLASH_MAIN} bf16 causal: kernel {flash['kernel']:.4f} ms "
          f"(tile {flash_tile}, {flash['flops'] / flash['kernel'] / 1e9:.2f} "
          f"TFLOP/s) | bound {flash['bound']:.4f} ms (FLOPs / 989 TFLOP/s; "
          f"bytes {flash['bytes'] / 1e6:.1f} MB / 3.35 TB/s = "
          f"{flash['bytes'] / HBM_PEAK * 1e3:.4f} ms) | plain "
          f"{flash['plain']:.4f} ms | scaled_dot_product_attention "
          f"{flash['library']:.4f} ms (kernel / library "
          f"{flash['kernel'] / flash['library']:.3f})")
    f32_ops = [x.float() for x in (fq, fk, fv)]
    want = attention_ref(*f32_ops, causal=True)
    errs["flash_f32_main"] = max(errs["flash_f32_main"], check_close(
        f"flash {FLASH_MAIN} f32 tile {flash_tile}", flash_attention(
            *f32_ops, causal=True, bq=flash_tile[0], bk=flash_tile[1]),
        want, FLASH_MAIN_TOL["f32"]))
    del want
    flash32 = {
        "kernel": cuda_ms(lambda: flash_attention(
            *f32_ops, causal=True, bq=flash_tile[0], bk=flash_tile[1]),
            iters=3, warmup=1),
        "plain": cuda_ms(lambda: attention_ref(*f32_ops, causal=True),
                         iters=2, warmup=1),
        "library": cuda_ms(lambda: torch.nn.functional
                           .scaled_dot_product_attention(
                               *f32_ops, is_causal=True, enable_gqa=True),
                           iters=5, warmup=1),
        "bound": max(flash["flops"] / F32_PEAK,
                     2 * flash["bytes"] / HBM_PEAK) * 1e3}
    print(f"flash {FLASH_MAIN} f32 causal (CUDA cores): kernel "
          f"{flash32['kernel']:.4f} ms (tile {flash_tile}, "
          f"{flash['flops'] / flash32['kernel'] / 1e9:.2f} TFLOP/s) | bound "
          f"{flash32['bound']:.4f} ms (FLOPs / 67 TFLOP/s) | plain "
          f"{flash32['plain']:.4f} ms | scaled_dot_product_attention "
          f"{flash32['library']:.4f} ms")
    del f32_ops
    # zamba2-2.7b's shared attention: D = 80, window 4096 = S
    d80 = [randn(1, 32, 4096, 80, dtype=torch.bfloat16) for _ in range(3)]
    want = attention_ref(*d80, causal=True, window=4096)
    flash_d80 = {}
    for tile in quick_tiles:
        errs["flash_attention"] = max(errs["flash_attention"], check_close(
            f"flash (1, 32, 4096, 80) bf16 window 4096 tile {tile}",
            flash_attention(*d80, causal=True, window=4096, bq=tile[0],
                            bk=tile[1]), want, FLASH_MAIN_TOL["bf16"]))
        n_checks["flash_attention"] += 1
        flash_d80[tile] = cuda_ms(lambda t=tile: flash_attention(
            *d80, causal=True, window=4096, bq=t[0], bk=t[1]), iters=10)
    del want
    d80_lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *d80, is_causal=True), iters=10)
    print("flash (1, 32, 4096, 80) bf16 causal, window 4096: " + " | ".join(
        f"tile {t} {ms:.4f} ms" for t, ms in flash_d80.items())
        + f" | scaled_dot_product_attention {d80_lib:.4f} ms")
    del d80
    leaves = [t.detach().requires_grad_() for t in (fq, fk, fv)]
    attn_fb = {
        "flash": cuda_ms(lambda: torch.autograd.grad(flash_attention(
            *leaves, bq=flash_tile[0], bk=flash_tile[1]), leaves, fg),
            iters=2, warmup=1),
        "plain": cuda_ms(lambda: torch.autograd.grad(_attend(
            *leaves, causal=True, window=None), leaves, fg), iters=2,
            warmup=1),
    }
    print(f"attention forward + backward at {FLASH_MAIN}: flash path "
          f"{attn_fb['flash']:.3f} ms (kernel forward, dense plain "
          f"backward) | plain path {attn_fb['plain']:.3f} ms (q-chunked, "
          f"checkpointed)")
    del fq, fk, fv, fg, leaves
    torch.cuda.empty_cache()
    ssd_time = {}
    for label, shape in SSD_MAIN.items():
        ops = ssd_inputs(ssd_gen, *shape)
        ey, eh = ssd_check(f"ssd {label} {shape}", ops)
        errs["ssd_y"], errs["ssd_state"] = (max(errs["ssd_y"], ey),
                                            max(errs["ssd_state"], eh))
        n_checks["ssd_chunk_scan"] += 1
        xdt, bm, cm, cum, _ = ops
        cost = ssd_shape_cost(shape)
        with torch.no_grad():
            t = {"kernel": cuda_ms(lambda: chunk_scan(
                     xdt, bm, cm, cum, return_state=True), iters=5, warmup=1),
                 "plain": cuda_ms(lambda: ssd_chunk_scan_ref(
                     xdt, bm, cm, cum, return_state=True), iters=2,
                     warmup=1)}
        ssd_time[label] = {**t, **cost, "shape": shape}
        print(f"ssd {label} (B, H, C, Q, P, N)={shape} f32: kernel "
              f"{t['kernel']:.4f} ms ({cost['flops'] / t['kernel'] / 1e9:.2f} "
              f"TFLOP/s of the formula's {cost['flops'] / 1e9:.1f} GFLOP, "
              f"{cost['blocks']} blocks) | bound {cost['bound']:.4f} ms "
              f"({cost['bound_by']}: needed {cost['needed'] / 1e9:.2f} GFLOP "
              f"/ 67 TFLOP/s, {cost['bytes'] / 1e9:.3f} GB / 3.35 TB/s; "
              f"{cost['bound'] / t['kernel']:.1%} of it) | plain "
              f"{t['plain']:.4f} ms | library: none (no PyTorch call "
              f"computes the chunk scan)")
        del ops, xdt, bm, cm, cum
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
    m = re.search(r"^trials    : (\d+)", runs["gemm_tiled"][0], re.M)
    if m is None or int(m.group(1)) != len(TILES):
        fail(f"gemm_tiled tuned {m and m.group(1)} tiles, want all "
             f"{len(TILES)} (the card's opt-in shared-memory limit)")

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

    # -- 6. model step ------------------------------------------------------
    phase("model step (granite-3-2b, 4 of 40 layers, B=1, S=4096)")
    step = model_step_path(WORK, MODEL_STEP)
    layers = MODEL_STEP["layers"]
    for flash_on, path in ((0, "plain"), (1, "flash")):
        fastest = min(ms for key, ms in step["step_ms"].items()
                      if key[0] == flash_on)
        attn = layers * attn_fb[path]
        print(f"use_flash={flash_on}: fastest step {fastest:.2f} ms; "
              f"attention forward + backward ~{layers} x "
              f"{attn_fb[path]:.3f} ms = {attn / fastest:.1%} of it"
              + (f"; flash kernel {layers} x {flash['kernel']:.3f} ms = "
                 f"{layers * flash['kernel'] / fastest:.1%} of it"
                 if flash_on else ""))

    # -- 7. full depth -------------------------------------------------------
    phase("full-depth step (granite-3-2b, 40 layers, B=1, S=4096)")
    deep = full_depth_step(step["tile"])

    # -- 8. SSM serving ------------------------------------------------------
    phase("SSM serving (mamba2-130m, 24 layers, 4 x 32768-token prefill, "
          "32 decode steps)")
    serving = serving_path()
    errs["continue"] = decode_continues_prefill()

    # -- 9. hybrid model step -------------------------------------------------
    phase("hybrid model step (zamba2-2.7b, 6 of 54 layers, B=1, S=4096)")
    hyb = model_step_path(WORK, HYBRID_STEP)
    parts = hybrid_layer_parts(hyb["tile"])
    print(f"one layer's parts alone (CUDA events, ms): SSD kernel forward "
          f"{parts['ssd_fwd']:.3f}, with its plain backward "
          f"{parts['ssd_fwd_bwd']:.3f}; shared attention forward + backward "
          f"{parts['flash_fwd_bwd']:.3f} on the flash path (flash kernel "
          f"forward {parts['flash_fwd']:.3f}), {parts['plain_attn_fwd_bwd']:.3f}"
          f" on the plain path")
    trace = step_trace(HYBRID_STEP, hyb["tile"])

    # -- result lines ------------------------------------------------------
    phase("result")
    print(f"total wall {time.perf_counter() - t_start:.1f}s")
    t_srv, t_hyb = ssd_time["mamba2 serving"], ssd_time["zamba2 train"]
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
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:33",
         "launches": (step["routes"]["tensor_cores"]
                      + hyb["routes"]["tensor_cores"]),
         "launches_granite_step": step["routes"]["tensor_cores"],
         "launches_zamba2_step": hyb["routes"]["tensor_cores"],
         "max_abs_err": errs["flash_attention"],
         "ms": flash["kernel"],
         "plain_ms": flash["plain"], "bound_ms": flash["bound"],
         "bound_by": "operations", "library_ms": flash["library"],
         "checks_passed": n_checks["flash_attention"],
         "shape": list(FLASH_MAIN), "tile": list(flash_tile),
         "tile_ms": {f"{t[0]}x{t[1]}": ms for t, ms in flash_ms.items()},
         "d80_tile_ms": {f"{t[0]}x{t[1]}": ms
                         for t, ms in flash_d80.items()},
         "d80_library_ms": d80_lib,
         "dtype": "bfloat16", "causal": True, "tensor_cores": True,
         "model_step_ms": step["step_ms"][(1, *step["tile"])],
         "full_depth_step_ms": deep["step_ms"],
         "full_depth_peak_gib": deep["peak_gib"]},
        {"name": "flash_attention_f32", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:33",
         "launches": step["f32_launches"],
         "launches_granite_f32_step": step["f32_launches"],
         "max_abs_err": errs["flash_f32_main"],
         "max_abs_err_f32_cases": errs["flash_f32_cases"],
         "ms": flash32["kernel"], "plain_ms": flash32["plain"],
         "bound_ms": flash32["bound"], "bound_by": "operations",
         "library_ms": flash32["library"], "shape": list(FLASH_MAIN),
         "tile": list(flash_tile), "dtype": "float32", "causal": True,
         "tensor_cores": False, "f32_loss_rel": step["f32_loss_rel"]},
        {"name": "ssd_chunk_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd.cu",
         "replaces": "src/repro/kernels/ssd/ssd.py:36",
         "launches": serving["launches"] + hyb["launches"]["ssd_chunk_scan"],
         "launches_serving": serving["launches"],
         "launches_zamba2_step": hyb["launches"]["ssd_chunk_scan"],
         "max_abs_err": errs["ssd_y"], "max_abs_err_state": errs["ssd_state"],
         "ms": t_srv["kernel"], "plain_ms": t_srv["plain"],
         "bound_ms": t_srv["bound"], "bound_by": t_srv["bound_by"],
         "library_ms": None,
         "library_note": "no single PyTorch call computes the SSD chunk scan",
         "checks_passed": n_checks["ssd_chunk_scan"],
         "shape": list(t_srv["shape"]), "dtype": "float32",
         "bound_flops": t_srv["needed"], "formula_flops": t_srv["flops"],
         "train_shape": list(t_hyb["shape"]), "train_ms": t_hyb["kernel"],
         "train_plain_ms": t_hyb["plain"], "train_bound_ms": t_hyb["bound"],
         "serving_prefill_ms": serving["prefill_ms"],
         "serving_decode_ms_per_step": serving["decode_ms"],
         "zamba2_step_ms": {f"use_flash={k[0]} tile=({k[1]}, {k[2]})": ms
                            for k, ms in hyb["step_ms"].items()},
         "zamba2_step_trace": {"wall_ms": trace["wall_ms"],
                               "device_busy_ms": trace["busy_ms"],
                               "device_ms": trace["parts"]}},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
