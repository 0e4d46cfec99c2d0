#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout: the kernels are built from
``src/repro_torch/csrc`` at first use. Phases, each of which fails the
run when it fails:

1. card      — ``nvidia-smi`` name and power limit; torch, CUDA, nvcc.
2. build     — compile the CUDA kernels for sm_90a, and beside them the
               designs the shipped ones replaced, each its own library,
               for their times only (``csrc/baseline/ssd_mma_sync.cu``,
               the mma.sync SSD, and ``csrc/baseline/
               matmul_cuda_cores.cu``, the CUDA-core GEMM in f32 and
               bf16); print the seconds, every kernel's
               registers, spills and static shared memory, the kernels
               that spill, the f32 GEMM at every tile (threads, registers
               at launch and a consumer's, spills, dynamic shared memory,
               blocks and consumer warps an SM; none may spill; the
               library's table and shared memory must be the wrapper's),
               the dynamic shared memory of the
               flash blocks (the CUDA-core kernel at each head dim, the
               bf16 and 3xTF32 tensor-core kernels at every tile, the
               latter, D = 256's too, with its registers and spills; the
               bf16 tensor-core GEMM at every tile with its registers and
               spills, which must not spill or serialise its wgmma, ptxas
               C7520), and each of the four SSD kernels' threads, dynamic
               shared memory, blocks per SM, registers and spills (none
               may spill or serialise its wgmma); the library's bf16, tf32x3
               and tf32x3_d256 flash tile tables and its bf16 GEMM table
               (and each tile's shared memory) must be the wrapper's.
3. checks    — each kernel against its plain PyTorch version on the card:
               the f32 GEMM at every tile of the table at 4096x2048x6144
               (each C bitwise equal to the replaced design's) and at
               300x450x200, 1024x256x128 and 129x65x33 (rows not 16 bytes
               apart), every launch on the CUDA-core route; the bf16
               tensor-core GEMM at every tile of its table at those four
               shapes, at a ragged 1000x1000x1000 and at 333x250x77
               (unaligned rows), every launch on the tensor-core route;
               TRIAD at
               n in {1024, 2**20 + 17, 2**26} in f32 and bf16 (plus an
               unaligned view that takes the scalar path), and at every
               length of the ``triad --full`` ladder in f32; flash
               attention on the cases of ``tests/test_kernels.py`` and
               at every head dim the configs use, each at every (bq, bk)
               of the full model-step space, each on its route (bf16 on
               the tensor-core kernel, f32 at D <= 128 on the 3xTF32 one
               and f32 at D = 256 on its D = 256 kernel, each of which
               must run every compiled physical tile), then at the model
               step's shape (B=1, H=32, Hkv=8, S=4096, D=64, causal) at each
               tile of the quick space, in bf16 and in f32 within
               FLASH_MAIN_TOL, and its
               autograd gradients against the plain version's (exact:
               the backward is the plain math); the SSD chunk scan's y
               and final state on SSD_CASES (the cases of
               ``tests/test_kernel_ssd.py``, an odd chunk, mamba2-130m's
               widths at Q in {128, 256, 512}, zamba2-2.7b's, N = 200,
               N = 256, B·H·C = 73,728 chunks and rows that are not 16
               bytes apart: P = 6, N = 10, Q = 50) within SSD_ULPS f32 ulps
               of the largest element, and its autograd gradients (exact).
4. timing    — CUDA-event times of each kernel at the main path's shapes
               (each checked against its plain version on the same
               tensors first) beside its bound, its plain version and one
               PyTorch call that computes the same function; the f32 GEMM
               and the CUDA-core design it replaced at every tile, in
               turns, and the host microseconds of a launch at 128^3
               through the wrapper (tensor maps) and the replaced
               launcher; the bf16
               GEMM at 4096x2048x6144 at every tensor-core tile, beside
               its bound at 989 TFLOP/s, torch.matmul and the CUDA-core
               bf16 instantiation it replaced at its best tile (checked
               too); TRIAD also
               replayed from a CUDA graph (device time without the host's
               dispatch); the host cost of one tuner sample at
               n = 1024, split into the wrapper's dispatch and the
               sampler's synchronize; the flash kernel at each quick tile
               beside scaled_dot_product_attention, in bf16 and in f32
               (the 3xTF32 kernel at each quick tile beside the CUDA-core
               kernel it replaced, checked first, its bounds at 165 and
               67 TFLOP/s and scaled_dot_product_attention),
               zamba2-2.7b's D = 80 at each quick tile (checked first),
               and gemma-2b's widths (FLASH_D256: B=1, H=8, Hkv=1,
               S=4096, D=256, causal): in f32 the D = 256 3xTF32 kernel
               at each quick tile (checked first) beside the CUDA-core
               kernel it replaced (checked too), its bounds at 165 and 67
               TFLOP/s, its plain version and
               scaled_dot_product_attention, and in bf16 the tensor-core
               kernel at each quick tile (checked first) beside its bound
               and scaled_dot_product_attention;
               attention forward + backward at
               the model step's shape on the flash and plain paths; the
               SSD kernel at SSD_MAIN (mamba2-130m serving, zamba2-2.7b
               train, mamba2-130m through the training launcher), checked
               first, beside its bounds (3xTF32 tensor
               cores and CUDA cores), the mma.sync design it replaced
               (checked too), its plain version (no PyTorch call computes
               it) and each of its four kernels' device time
               (``torch.profiler``).
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
               kernel, are required (each config's samples replay a
               CUDA graph of its step, captured at its pre-heat), and the
               4-layer loss with ``use_flash=1`` must match
               ``use_flash=0`` on the same weights within
               MODEL_STEP["loss_rtol"]; the plain and the best flash
               step eager against captured, in turns (ms, GFLOP/s and
               peak memory of each); then the same in float32 (the
               3xTF32 flash kernel, one launch a layer) within
               MODEL_STEP["f32_loss_rtol"], and that f32 step's time on
               the flash and plain paths.
6b. gemma f32 — gemma-2b's train step in float32 (GEMMA_F32_STEP: full
               width, d_model 2048, 8 heads, 1 kv head, head dim 256,
               vocab 256000; depth cut from 18 to 2 layers, B=1, S=4096)
               at phase 6's tile: the ``use_flash=1`` loss within
               F32_LOSS_RTOL of ``use_flash=0``, exactly 2 launches of the
               D = 256 3xTF32 flash kernel and none on another route; the
               step's time on the flash and plain paths.
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
               4352-token prefill within CONTINUE_TOL. Then
               granite-3-2b (40 layers) and zamba2-2.7b (54) at full
               width and depth through ``repro_torch.launch.serve.serve``
               (SERVE: 4 prompts of 4096 tokens, 32 generated; cut from
               decode_32k's batch 128 and 32768-token context), each
               after a warm-up serve (SERVE_WARMUP): finite logits,
               tokens in the vocabulary, the KV cache's shape and dtype,
               no flash launch (the reference's prefill is plain), and
               for zamba2 exactly one SSD launch per layer (54) in the
               timed serve (its decode captured from the second step);
               prefill ms and tokens/s, decode ms per step, peak memory.
               From the cache each serve left (and mamba2's decode),
               GRAPH_STEPS decode steps through
               ``launch.serve.greedy_decode`` eagerly and as ``generate``
               runs it on the card (captured), and the replays of the
               same captured step alone: the eager tokens required of
               both, ms per step and peak memory of each, and the host's
               time to enqueue the eager steps. granite's decode at decode_32k's
               context (LONG_DECODE: 10.7 GB of seeded random K/V, 16
               steps from position 32768): finite logits, tokens in the
               vocabulary, ms per step, peak memory. In f32 at full
               width (SERVE_CONTINUE: granite 4 layers, zamba2 6; B=1),
               a 512-token prefill and 64 teacher-forced decode steps
               against one 576-token prefill: the last logits and every
               cache leaf within CONTINUE_TOL. Last, ``python -m
               repro_torch.launch.serve --arch granite_3_2b --smoke`` on
               the card.
9. hybrid    — as phase 6 on zamba2-2.7b's train step (HYBRID_STEP: full
               width, depth cut from 54 to 6 layers, B=1, S=4096): every
               config must launch the SSD kernel, and the flash kernel
               exactly when ``use_flash=1`` (head dim 80); then CUDA-event
               times of one layer's parts alone, and a ``torch.profiler``
               trace of one step at the tuner's flash tile: the device's
               idle share of the step, and the device time of the SSD
               kernel, the flash kernel, their plain backward passes and
               the rest.
10. device timing — traced ``Tuner`` sessions with
               ``EvaluationSettings(device_timing=True)``: DGEMM over the
               card-sized space (8 configs), and TRIAD at 256 KiB, 4 MiB
               and 256 MiB, each in a one-config session of its own. Every
               incumbent trial must give one ``device_timing`` instant
               (``torch.profiler``) with 0 < device time <= host bracket
               and at least one kernel event, none may give
               ``device_timing_unavailable``, and at 4 MiB and 256 MiB the
               profiled TRIAD kernel must lie within
               DEVICE_TIMING_AGREEMENT of phase 4's graph-replay time;
               each trial's host bracket, device time and skew are printed.
11. paper tables — ``repro_torch.bench.run``'s PAPER_BENCHES quick on the
               card (Tables IV/V, VI, VII, VIII-XI, Fig. 6 and the GEMM
               tile search): every table non-empty and finite, every
               technique row of ``optimizations`` present, C+I+O taking
               fewer samples than Default, the tile search's winner
               matching ``matmul_ref``, and the bf16 tile search's (the
               tensor-core GEMM over its table at 4096x2048x6144: some
               launches, all on the tensor-core route) matching it within
               3e-2; the harness self-benchmark, whose
               timed-vs-steady agreement at 2048^3 must lie within its 2%
               (its non-measured ratios are printed, not checked); then
               ``python -m repro_torch.tune --benchmark dgemm`` over the
               card space on the serial, ``simulated:4`` and ``process:2``
               backends: all 8 configs each, and the two new backends'
               F_p within F_P_AGREEMENT of the serial session's. The
               phase runs to its end before it fails on any of these.
12. history and search — in fresh cache dirs: ``python -m
               repro_torch.tune --benchmark gemm_tiled --history``
               exhaustively (all 12 tiles) twice, the second ``--fresh``:
               the run ledger must hold both runs, both must launch the
               GEMM kernel, and ``python -m repro_torch.perf_gate`` must
               exit 0 on them; after a copy of the newest record with its
               mean scaled by 0.9 is appended, it must exit 1 naming that
               series (each verdict's Welch interval is printed). Then
               ``--strategy surrogate --budget 8 --seed 0`` over the tiles
               (its best tile and the trial that found it, beside the
               exhaustive winner) and ``--strategy bandit`` over the
               card's DGEMM space, each with a finite best; ``python -m
               repro_torch.sweep --benchmark dgemm`` over SWEEP (a finite
               best for every tuned shape, the oracle's answer for the
               held-out shape, its gap and the trials spent against the
               exhaustive count); and ``python -m
               repro_torch.roofline_report`` over phase 5's cache dir
               (which now holds its run ledger) with ``--html``,
               ``--history`` (the gate's ledger) and ``--trace`` (phase
               10's DGEMM trace): the page must show phase 5's F_p, the
               gemm_tiled trend, the verdicts and the trial drill-down.
13. observability and lint — each of the four ``repro_torch::*`` ops on
               the card: ``FlopCounterMode`` and ``count_ops`` must see
               exactly that op with its formula's FLOPs, and its output
               must equal the wrapper's launch on the same inputs bit for
               bit; the host microseconds a call of TRIAD through the op
               (n = 1024), beside the launch function without the op and
               the bare ctypes launch. ``python -m repro_torch.lint
               --json`` (pass 1 bound to the card) must report no warning
               or error; ``python -m repro_torch.tune --benchmark triad
               --validate strict --live`` and a 3-tile random
               ``gemm_tiled`` session the same way must finish with their
               live lines, and a mis-declared benchmark under
               ``validate="strict"`` must raise before its first trial. Then measured
               attribution at full width on phase 5's roofs (OBSERVE):
               granite-3-2b's train step (4 layers, B=1, S=4096,
               ``use_flash=1`` at phase 6's tile), mamba2-130m's prefill
               (4 x 32768 tokens) and zamba2-2.7b's train step (6 layers,
               B=1, S=4096, flash at the same tile): each prints its top
               ops, its time by op kind, its subsystem shares and
               ``unattributed_frac`` and writes its JSON, and the flash op
               and the SSD op must each hold device time where the model
               runs them. Last, ``python -m
               repro_torch.roofline_report --attribute train_step --html``
               (the tiny step, measured on the card).
14. model stack — the MoE, VLM and enc-dec families at full width:
               the bf16 flash kernel at the causal self-attention shape
               of each train step below (llama-3.2-vision-11b's D = 128,
               granite-moe's H = 16, whisper's B = 8 over 448 tokens)
               checked at each quick tile against its plain version on
               the tensor-core route, the D = 128 shape also timed beside
               its bound and scaled_dot_product_attention; the train steps of
               STACK_STEP (granite-moe-1b-a400m at all 24 layers, B=1,
               S=4096; llama-3.2-vision-11b cut to 10 layers, B=1, S=4096;
               whisper-base at B=8 with 1500 frames and 448 tokens) with
               ``use_flash`` 0 and 1: finite losses and gradients, the
               losses within MODEL_STEP["loss_rtol"], one flash launch per
               causal self-attention layer on the flash path and none on
               the plain one; the serves of STACK_SERVE (granite-moe and
               llama-vision at full depth, 4 x 4096 + 32, the latter with
               its 1600 image embeddings; mixtral-8x22b cut to 8 layers,
               1 x 4096 + 16 through ``generate``; whisper with its
               frames) as phase 8's, the VLM's cache holding its 32 self
               layers and whisper's the cross K/V of its 1500 frames, and
               each one's decode eager against captured as phase 8's (the
               same tokens); and decode continuing prefill in f32 at
               STACK_CONTINUE's depths within CONTINUE_TOL, with the
               smallest top-k router gap of each MoE model. Each run
               prints its widths, depth and cuts, time, peak memory and
               launches.
15. training launch — ``adamw_update`` on the card against the same
               three steps on the host (ADAMW_CHECK: granite-3-2b's widest
               leaf in bf16 and f32, its embedding, a norm); then
               mamba2-130m at its published config (24 layers,
               d_model 768, vocab 50280, bf16) trained through
               ``repro_torch.launch.train.train`` at B=8, S=2048
               (TRAIN_LAUNCH): 40 steps straight, replayed from a CUDA
               graph from the third, whose loss must fall by more than
               0.05; then 20 steps with a checkpoint and a run that
               resumes from it to step 40, whose last loss must equal the
               straight run's within rtol 1e-4; before and after them two
               eager runs of 6 steps, whose spread bounds the captured
               losses' difference from the eager ones; every run
               launches the SSD kernel, 48 times a step, on the host mesh.
               Then granite-3-2b at all 40 layers (TRAIN_DENSE: B=1,
               S=4096, batch 256 -> 1) through
               ``train.steps.build_train_step`` with the bf16 flash kernel
               at phase 6's tile, remat and AdamW, 7 steps in turns eager
               and captured, every flash launch on the tensor cores, 80 a
               step; the eager and the replayed step's ms and each one's
               peak memory. Each run prints its widths,
               depth and cuts, step ms, the AdamW update's ms alone (CUDA
               events around it), the global norm, peak memory, the first
               and last loss and its launches per step by kernel and route.
16. distribution — the dry runs of DRY_RUN and ``launch.perf``'s
               variant in processes that see no card; granite-3-2b's
               sharded train step (DIST_STEP: 4 of 40 layers, B=1, S=4096)
               on ``make_host_mesh()`` through ``bundle.jitted()``,
               captured from its second step, bitwise against the captured
               meshless step and within two eager meshless runs' spread of
               them, the dry run's peak estimate within PEAK_ESTIMATE of
               the measured peak, one step per remat policy; then the
               ``distributed_tuner`` bench. Step ms eager, captured
               meshless and captured sharded, and peak memory.

Each phase prints its seconds.

The last three lines are the card line, one ``{"kernels": [...]}`` JSON
object (the GEMM split by dtype: ``matmul`` the f32 CUDA-core kernel,
with the design it replaced as ``was_ms``, ``matmul_bf16`` the
tensor-core kernel, with the CUDA-core bf16
instantiation it replaced as ``was_ms`` and phase 11's bf16 tile search
as its launches; flash attention split by dtype: ``flash_attention`` the bf16
tensor-core kernel, ``flash_attention_f32`` the 3xTF32 one, with the
CUDA-core kernel it replaced as ``was_ms``, and
``flash_attention_f32_d256`` the 3xTF32 kernel at D = 256, the same
CUDA-core kernel its ``was_ms``; ``launches`` counts the main path's
launches, phase 5's for matmul (f32) and triad, phase 11's for
matmul_bf16, phases 6, 9 and 14's for bf16
flash (phase 14's: ``launches_model_stack``), phase 6's granite f32 step
for ``flash_attention_f32`` and phase 6b's gemma f32 step for
``flash_attention_f32_d256``, phases 8 and 9's for the SSD chunk scan
(serving: ``launches_serving``), with phase 15's for both as
``launches_training`` and phases 10, 11,
12 and 13's beside it as ``launches_device_timing``,
``launches_paper_tables``, ``launches_history_search`` and
``launches_observability``) and
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
#: small f32 and bf16 shapes: ragged, and (129, 65, 33) rows that are not
#: 16 bytes apart (the f32 kernel's operands copied into rounded-up rows)
GEMM_SMALL = ((300, 450, 200), (1024, 256, 128), (129, 65, 33))
#: the f32 tile whose replaced-design C the f32 kernel's is held to bitwise
DEFAULT_F32_TILE = (128, 128, 16)
#: the bf16 tensor-core GEMM's edge cases, each at every tile of its table:
#: m, n and k multiples of no tile (rows still 16-byte multiples), and rows
#: that are not (A's and B's rows copied into rounded-up strides)
GEMM_BF16_EDGES = {"ragged": (1000, 1000, 1000),
                   "unaligned stride": (333, 250, 77)}
TRIAD_CHECK_N = (1024, 2 ** 20 + 17, 2 ** 26)
TRIAD_SIZES = {"cache": 1 << 22, "dram": 1 << 28}  # roofline-model bytes
F32_PEAK = 67e12                           # H100 SXM data sheet, 700 W
HBM_PEAK = 3.35e12
BF16_PEAK = 989e12                         # tensor cores, bf16, dense
TF32_PEAK = 495e12                         # tensor cores, tf32, dense
#: f32-accurate products from the TF32 tensor cores, three products each
#: (the 3xTF32 split of the SSD kernel and the f32 flash kernel)
TF32X3_PEAK = TF32_PEAK / 3
SUBPROCESS_TIMEOUT_S = 420
#: phase 13's measured attributions: granite-3-2b's and zamba2-2.7b's
#: train steps at phases 6 and 9's depth and shape on the flash path, and
#: mamba2-130m's prefill at phase 8's batch and prompt length; each must
#: give its hand-kernel ops device time
OBSERVE = {"granite": {"arch": "granite_3_2b", "layers": 4, "batch": 1,
                       "seq": 4096, "workload": "train_step",
                       "ops": ("flash_attention_fwd",)},
           "mamba2": {"arch": "mamba2_130m", "layers": 24, "batch": 4,
                      "seq": 32768, "workload": "prefill_step",
                      "ops": ("ssd_chunk_scan_fwd",)},
           "zamba2": {"arch": "zamba2_2_7b", "layers": 6, "batch": 1,
                      "seq": 4096, "workload": "train_step",
                      "ops": ("flash_attention_fwd", "ssd_chunk_scan_fwd")}}
#: TRIAD working sets of the device-timing phase, each in a one-config
#: session of its own (only a trial that beats the incumbent is profiled)
DEVICE_TIMING_TRIAD = {"256 KiB": 1 << 18, "cache": 1 << 22, "dram": 1 << 28}
#: the profiled TRIAD kernel against phase 4's CUDA-event graph-replay
#: time of the same tensor size (device time without the host's dispatch)
DEVICE_TIMING_AGREEMENT = 0.25
#: the paper-table benches phase 11 runs (``roofline_model`` ran in phase
#: 5, ``distributed_tuner`` runs in phase 16)
PAPER_BENCHES = ("matmul_peak", "triad", "iteration_counts", "size_sweep",
                 "optimizations", "kernel_autotune")
FLASH_MAIN = (1, 32, 8, 4096, 64)          # (B, H, Hkv, S, D), granite-3-2b
FLASH_TOL = {"f32": {"rtol": 2e-5, "atol": 2e-5},   # tests/test_kernels.py
             "bf16": {"rtol": 3e-2, "atol": 3e-2}}
# At FLASH_MAIN an output element of unit-normal q, k, v is about 0.03, as
# large as the test tolerance above, so the main shape gets limits from the
# rounding instead: the plain version computes in f32 and rounds once to
# bf16; the tensor-core kernel also rounds P to bf16 before P V (its max
# abs error there reads 7.8e-3 to 1.6e-2 on an H100, by the seeded draw,
# against 1.95e-3 for the CUDA-core kernel, PERF.md), within two bf16 ulps
# (2**-8 relative; rtol 1.6e-2) plus atol 4e-3. In f32 the kernel differs
# by its products' rounding (3xTF32, ~22 bits each) and the order of its
# sums only (see F32_LOSS_RTOL). A kv sub-tile dropped or misweighted at
# long S moves outputs by ~1e-3.
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
# In float32 the flash kernel (3xTF32 on the tensor cores: ~22 of f32's 24
# bits a product) and the plain attention differ by their products'
# rounding and the order of their sums: at the main shape, where an output
# element is about 0.03, the largest error reads 1.2e-6 absolute on an H100
# (7.7e-7 for the CUDA-core kernel it replaced, same run; PERF.md), within
# FLASH_MAIN_TOL. Through 4 layers that is far below the limit, which a
# kernel wrong in one layer or a share of rows exceeds.
F32_LOSS_RTOL = 1e-5
#: timed runs of each float32 4-layer train step (median)
F32_STEP_REPEATS = 3
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
#: granite-3-2b and zamba2-2.7b served through ``launch.serve.serve`` at
#: full width and depth: 4 prompts of 4096 tokens (train_4k's sequence),
#: 32 generated tokens. Cuts: decode_32k's global batch 128 -> 4 (its KV
#: cache would be 344 GB at 128 x 32768), and the prompt 32768 -> 4096
#: (the plain masked prefill attention the reference runs would cost
#: ~1.4e15 f32 FLOPs over granite's 40 layers at 32768, ~30 s). zamba2's
#: decode runs past its 4096 window. Each timed serve follows a short
#: warm-up serve (SERVE_WARMUP).
SERVE = {"granite": {"arch": "granite_3_2b", "batch": 4, "prompt": 4096,
                     "gen": 32},
         "zamba2": {"arch": "zamba2_2_7b", "batch": 4, "prompt": 4096,
                    "gen": 32}}
SERVE_WARMUP = {"prompt": 512, "gen": 2}
#: decode steps replayed from one captured CUDA graph of a decode step,
#: beside the same steps in the eager loop
GRAPH_STEPS = 32
#: calls a turn when a model step is timed eager against captured (four
#: turns: eager, captured, captured, eager)
STEP_REPS = 2
#: granite-3-2b decode at decode_32k's context (batch cut as in SERVE): a
#: cache of 4 x (32768 + 16) slots whose first 32768 hold seeded random
#: K/V tagged 0..32767, then 16 greedy steps from position 32768
LONG_DECODE = {"batch": 4, "context": 32768, "steps": 16}
#: decode continuing prefill in f32 at full width, B = 1: granite cut to 4
#: layers, zamba2 to 6 (one group of Mamba2 layers, one shared-block use);
#: a 512-token prefill and 64 teacher-forced decode steps against one
#: 576-token prefill, every cache leaf and the last logits within
#: CONTINUE_TOL
SERVE_CONTINUE = {"layers": {"granite_3_2b": 4, "zamba2_2_7b": 6},
                  "prefill": 512, "decode": 64}
#: gemma-2b's attention widths (B, H, Hkv, S, D): D = 256, in f32 the
#: 3xTF32 kernel of csrc/flash_attention_tf32x3_d256.cu (launched by phase
#: 6b's step), timed in phase 4 beside the CUDA-core kernel it replaced,
#: and in bf16 the tensor-core kernel
FLASH_D256 = (1, 8, 1, 4096, 256)
#: phase 6b: gemma-2b's train step in float32, the path that launches the
#: f32 flash kernel at D = 256. Full width (d_model 2048, 8 heads, 1 kv
#: head, head dim 256, d_ff 16384, vocab 256000); depth cut from 18 to 2
#: layers, B=1 (batch 256 -> 1), S=4096 (the train_4k sequence); flash at
#: phase 6's tile; the loss within F32_LOSS_RTOL of the plain step's
GEMMA_F32_STEP = {"arch": "gemma_2b", "layers": 2, "batch": 1, "seq": 4096}
#: (B, H, C, Q, P, N, with h0): the cases of tests/test_kernel_ssd.py (its
#: four shapes and the state-carry case), an odd chunk (S = 300, Q = 100),
#: mamba2-130m's widths at S = 4096 with Q in {128, 256, 512} (the config's
#: chunk and the knob space of src/repro/launch/perf.py:73), zamba2-2.7b's,
#: N = 200 (a ragged last k slice) and N = 256 (the widest state taken), and
#: B·H·C = 73,728 chunks, and rows that are not 16 bytes apart (P = 6,
#: N = 10, Q = 50: the rounded-up copies TMA needs)
SSD_CASES = (
    [(2, 3, 4, 16, 8, 16, False), (2, 3, 4, 32, 16, 8, False),
     (1, 8, 2, 16, 8, 16, False), (2, 3, 8, 8, 8, 16, False),
     (1, 1, 3, 8, 4, 4, False), (1, 1, 3, 8, 4, 4, True),
     (1, 24, 3, 100, 64, 128, True)]
    + [(1, 24, 4096 // q, q, 64, 128, False) for q in (128, 256, 512)]
    + [(1, 80, 32, 128, 64, 64, False)]
    + [(1, 3, 4, 96, 64, 200, True), (2, 2, 3, 128, 32, 256, False),
       (1, 9, 8192, 8, 8, 16, False), (1, 3, 2, 50, 6, 10, True)])
#: the main path's shapes (B, H, C, Q, P, N): mamba2-130m serving,
#: zamba2-2.7b's train step and mamba2-130m trained through the launcher
#: (phase 15: B=8, S=2048)
SSD_MAIN = {"mamba2 serving": (4, 24, 128, 256, 64, 128),
            "zamba2 train": (1, 80, 32, 128, 64, 64),
            "mamba2 train": (8, 24, 8, 256, 64, 128)}
# The kernel's products carry ~22 of f32's 24 bits (3xTF32 on the tensor
# cores, partial sums added on the CUDA cores) and its sums run in another
# order than the plain version's: the limit is SSD_ULPS f32 ulps (2**-23)
# of the largest output element, per element, far below the reference
# tests. 2e-5 times that magnitude; on an H100 the error reads under 5
# such ulps (the CUDA-core design of PR 13 read under 3; PERF.md). A
# dropped or misplaced 64-position sub-tile moves outputs by O(0.1) or
# more.
SSD_ULPS = 8
# The roofline model and the ``dgemm --full`` session time the same random
# configs with the same sampler, so their F_p differ by run-to-run noise
# and the model's smaller per-config budget only.
F_P_AGREEMENT = (0.8, 1.25)
#: phase 12's DGEMM shape sweep: a 3x3 grid at K = 1024, three proposals a
#: shape, the middle shape held out for the oracle (9 - 1 tuned shapes)
SWEEP = {"grid": "m=1024,2048,4096;n=1024,2048,4096;k=1024", "budget": 3,
         "holdout": "m=2048,n=2048,k=1024", "tuned": 8}
#: phase 14's train steps at full width, each with use_flash 0 and 1 at
#: phase 6's tile, their losses within MODEL_STEP["loss_rtol"] and one
#: flash launch a causal self-attention layer a step (the backward
#: recomputes through the plain attention). granite-moe at full depth
#: (24 layers, 32 experts, top-8); llama-vision cut from 40 to 10 layers
#: (two groups of 4 self layers and a cross layer; 8 flash layers);
#: whisper at full depth with its 1500 frames and 448 text tokens (its
#: text context) at B = 8 (6 flash layers: the decoder's). The kernel is
#: held to the plain attention at each of these shapes directly
#: (flash_stack_checks); the loss comparison is a second check, as a
#: whole-model number on random weights need not move past its limit for
#: a kernel wrong on a padded tail or a share of rows.
#: timed steps of each (after a warm-up step), the faster one reported
STACK_STEP_REPEATS = 2
STACK_STEP = {"granite_moe": {"arch": "granite_moe_1b_a400m", "batch": 1,
                              "seq": 4096},
              "llama_vision": {"arch": "llama_3_2_vision_11b", "layers": 10,
                               "batch": 1, "seq": 4096},
              "whisper": {"arch": "whisper_base", "batch": 8, "seq": 448}}
#: phase 14's serves (each after SERVE_WARMUP): granite-moe and
#: llama-vision at full depth, 4 x 4096 + 32 (cut from decode_32k as in
#: SERVE; llama-vision with its 1600 image embeddings); mixtral-8x22b cut
#: from 56 to 8 layers (a layer holds 4.8 GB of bf16 experts: 56 do not
#: fit in 80 GB), 1 x 4096 + 16 through ``generate``; whisper at full
#: depth with its frames, 4 x 416 + 32 (448 positions, its text context)
STACK_SERVE = {"granite_moe": {"arch": "granite_moe_1b_a400m", "batch": 4,
                               "prompt": 4096, "gen": 32},
               "mixtral": {"arch": "mixtral_8x22b", "layers": 8,
                           "batch": 1, "prompt": 4096, "gen": 16},
               "llama_vision": {"arch": "llama_3_2_vision_11b", "batch": 4,
                                "prompt": 4096, "gen": 32},
               "whisper": {"arch": "whisper_base", "batch": 4,
                           "prompt": 416, "gen": 32}}
#: phase 14's f32 decode-continues-prefill (SERVE_CONTINUE's lengths) at
#: full width: granite-moe cut to 4 layers, mixtral to 2, llama-vision to
#: 5 (one group: 4 self layers and a cross layer), whisper at its 6
STACK_CONTINUE = {"granite_moe_1b_a400m": 4, "mixtral_8x22b": 2,
                  "llama_3_2_vision_11b": 5, "whisper_base": 6}

#: phase 15's training launch: (a) mamba2-130m at its published config
#: through ``launch.train.train``: ``steps`` straight, then ``split``
#: steps with a checkpoint and a resumed run to ``steps`` (the loss must
#: fall by more than ``loss_drop``, the reference's criterion of
#: tests/test_system.py; the resumed last loss equal the straight one
#: within ``resume_rtol``, the reference's test_train_resume_equivalence),
#: captured from the second step of a run, between two eager runs of
#: ``eager_steps``; (b) granite-3-2b at all 40 layers through
#: ``build_train_step`` with flash, remat and AdamW, B=1, S=4096 (batch
#: 256 -> 1, as phase 7), one run whose steps go eagerly or through the
#: bundle's captured step as ``modes`` lists them; no checkpoint (its
#: state is 25 GB on disk)
TRAIN_LAUNCH = {"arch": "mamba2_130m", "batch": 8, "seq": 2048,
                "steps": 40, "split": 20, "loss_drop": 0.05,
                "resume_rtol": 1e-4, "eager_steps": 6}
TRAIN_DENSE = {"arch": "granite_3_2b", "batch": 1, "seq": 4096,
               "modes": ("eager", "eager", "captured", "captured",
                         "captured", "captured", "eager")}
#: phase 15's check of ``adamw_update`` on the card against the same call
#: on the host: granite-3-2b's widest leaf (one layer of its (40, 2048,
#: 8192) stack) in bf16 and in f32, its embedding and a norm in bf16,
#: one step per lr in ``lrs`` with the clip active (the gradients' norm
#: ~1e4), each step held to the host's and then started again from the
#: host's values. The float32 moments and leaf are held at the CPU parity
#: test's clipped tolerance (rtol 1e-6 plus 1e-6 of the largest
#: magnitude: the two devices sum the norm's squares in other orders, so
#: the clip scale may differ by an ulp); a bf16 leaf within one bf16 ulp
#: (rtol 2**-7, plus the same atol where p and lr·update nearly cancel),
#: as such an f32 ulp can move p32 across a rounding boundary, in at most
#: ``flip_share`` of its elements. Carried over steps, such ulps add up,
#: hence the restart. A leaf the update left as it was is off by
#: lr·update ~ 1e-2, half an element at granite's init scale.
ADAMW_CHECK = {"lrs": (1e-2, 2e-2, 3e-2), "flip_share": 1e-3}


#: phase 16 (a): the dry-run cells, each in a process that sees no card
DRY_RUN = {"granite": ["--arch", "granite_3_2b", "--shape", "train_4k",
                       "--mesh", "single"],
           "zamba2": ["--arch", "zamba2_2_7b", "--shape", "decode_32k",
                      "--mesh", "multi", "--no-analysis"]}
#: phase 16 (b): the perf driver's variant
PERF_VARIANT = ["--arch", "granite_3_2b", "--shape", "train_4k",
                "--remat-policy", "dots_saveable"]
#: phase 16 (c, d): granite-3-2b's sharded train step on the host mesh
DIST_STEP = {"arch": "granite_3_2b", "layers": 4, "batch": 1, "seq": 4096,
             "steps": 5}
#: phase 16 (c): the dry run's peak-bytes estimate of the step against
#: torch.cuda.max_memory_allocated
PEAK_ESTIMATE = (0.5, 2.0)
#: phase 16 (d): the remat policies, aliases left out (same code)
DIST_POLICIES = ("nothing_saveable", "everything_saveable", "dots_saveable",
                 "dots_with_no_batch_dims_saveable")


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
    FLASH_CASES, each at every (bq, bk) of the full model-step space, each
    on the route its dtype and head dim take (``route``): the bf16 cases
    on the tensor-core kernel, the f32 cases at D <= 128 on the 3xTF32 one
    and at D = 256 on its D = 256 kernel, which must each have run every
    compiled physical tile of every head dim. Returns (checks, max abs err
    over the f32 cases)."""
    import torch
    from repro_torch.bench.common import model_step_space
    from repro_torch.kernels.flash_attention import (ROUTE_TILES,
                                                     attention_ref,
                                                     flash_attention,
                                                     padded_blocks,
                                                     physical_tile, route)
    tiles = sorted({(c["flash_block_q"], c["flash_block_k"])
                    for c in model_step_space(False).configs()})
    # physical tiles run, per tensor-core route and head dim
    ran = {r: {d: set() for d in t} for r, t in ROUTE_TILES.items()}
    checks, worst_f32 = 0, 0.0
    for b, hq, hkv, s, d, causal, window, dt in FLASH_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q, k, v = (randn(b, h, s, d, dtype=dtype) for h in (hq, hkv, hkv))
        want = attention_ref(q, k, v, causal=causal, window=window)
        path = route(dtype, d)
        label = (f"flash b={b} h={hq}/{hkv} s={s} d={d} causal={causal} "
                 f"window={window} {dt} ({path})")
        worst = 0.0
        for bq, bk in tiles:
            routed = flash_attention.route_launches[path]
            got = launch_checked(flash_attention, lambda: flash_attention(
                q, k, v, causal=causal, window=window, bq=bq, bk=bk))
            if flash_attention.route_launches[path] != routed + 1:
                fail(f"{label}: the {path} kernel did not launch")
            worst = max(worst, check_close(f"{label} tile ({bq}, {bk})", got,
                                           want, FLASH_TOL[dt]))
            checks += 1
            bq_, bk_, _ = padded_blocks(s, bq, bk)
            ran[path][d].add(physical_tile(bq_, bk_, ROUTE_TILES[path][d]))
        if dt == "f32":
            worst_f32 = max(worst_f32, worst)
        print(f"{label}: {len(tiles)} tiles ok, max abs err {worst:.3e}")
    for path, table in ROUTE_TILES.items():
        for d, compiled in table.items():
            if ran[path][d] != set(compiled):
                fail(f"flash {path} d={d}: the cases ran physical tiles "
                     f"{sorted(ran[path][d])}, not every compiled one "
                     f"{compiled}")
        print(f"flash {path}: every compiled (head dim, physical tile) "
              f"checked: {sum(map(len, ran[path].values()))} kernels")
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
    wrapped.audit_spec = bench.audit_spec
    wrapped.__name__ = bench.__name__
    return wrapped


def eager_vs_captured(fn, args: tuple, reps: int = STEP_REPS) -> dict:
    """``fn(*args)`` (a step whose arguments are the same tensors at every
    call, as the tuner's model steps are) eagerly and replayed from a
    CUDA graph (``graphs.captured``: an eager warm-up, then the capture),
    in turns eager, captured, captured, eager, ``reps`` calls a turn,
    each call timed on the host's clock between two synchronizes: each
    mode's median ms and peak memory (the captured one's over its warm-up
    and capture)."""
    import gc
    import statistics
    import torch
    from repro_torch import graphs
    step = graphs.captured(fn)
    gc.collect()
    torch.cuda.empty_cache()
    peaks = {}
    for mode, call, n in (("eager", fn, 1), ("captured", step, 2)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(n):
            call(*args)
        torch.cuda.synchronize()
        peaks[mode] = torch.cuda.max_memory_allocated() / 2 ** 30
    times: dict = {"eager": [], "captured": []}
    for mode in ("eager", "captured", "captured", "eager"):
        call = fn if mode == "eager" else step
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(*args)
            torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t0) * 1e3)
    step.release()
    gc.collect()
    torch.cuda.empty_cache()
    return {"eager_ms": statistics.median(times["eager"]),
            "captured_ms": statistics.median(times["captured"]),
            "eager_peak_gib": peaks["eager"],
            "captured_peak_gib": peaks["captured"]}


def model_step_path(work: pathlib.Path, spec: dict) -> dict:
    """Tune one model's train step (full width, ``spec``'s depth, batch
    and sequence) over the quick model-step space in process (on the
    card each config's samples replay a CUDA graph of its step); check
    the session, that every config launched the SSD kernel where the
    model has Mamba2 layers and the flash kernel exactly when
    ``use_flash=1``, and the flash/plain loss agreement within
    ``spec["loss_rtol"]``; then the plain and the best flash step eager
    against captured (:func:`eager_vs_captured`). Returns what the result
    line needs."""
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
    if routes != {**dict.fromkeys(routes, 0),
                  "tensor_cores": launches["flash_attention"]}:
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
    compare = {}
    for label, step in (("use_flash=0", StepConfig(remat=False)),
                        (f"use_flash=1 {tile}",
                         StepConfig(use_flash=True, flash_block_q=tile[0],
                                    flash_block_k=tile[1], remat=False))):
        wc = w.with_step(step)
        c = compare[label] = eager_vs_captured(wc.fn, wc.args)
        print(f"  {label} step, median of {2 * STEP_REPS} each, in turns: "
              f"eager {c['eager_ms']:.2f} ms "
              f"({flops / c['eager_ms'] / 1e6:.1f} GFLOP/s), peak "
              f"{c['eager_peak_gib']:.2f} GiB; captured "
              f"{c['captured_ms']:.2f} ms "
              f"({flops / c['captured_ms'] / 1e6:.1f} GFLOP/s), peak "
              f"{c['captured_peak_gib']:.2f} GiB")
    del w
    gc.collect()
    torch.cuda.empty_cache()
    out = {"launches": launches, "routes": routes, "tile": tile,
           "step_ms": step_ms, "best": result.best_config, "wall": wall,
           "loss_rel": rel, "compare": compare}
    if "f32_loss_rtol" in spec:
        out.update(f32_loss(cfg, b, s, tile, spec["f32_loss_rtol"]))
    return out


def f32_loss(cfg, b: int, s: int, tile: tuple[int, int], rtol: float
             ) -> dict:
    """The same step in float32 (weights, activations, attention): the
    loss with ``use_flash=1``, which runs the f32 flash kernel of the
    head dim's route on the tensor cores (3xTF32: ``tf32x3``, or
    ``tf32x3_d256`` at D = 256), one launch a layer and none on another
    route, against ``use_flash=0`` within ``rtol``; then each step's
    median milliseconds over F32_STEP_REPEATS runs (host clock,
    synchronized). Returns the relative difference, the route, the f32
    kernel's launches in the two loss steps and the step times."""
    import dataclasses
    import gc
    import statistics
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import route
    from repro_torch.models.transformer import StepConfig
    from repro_torch.models.workloads import build_workload
    cfg = dataclasses.replace(cfg, dtype="float32")
    path = route(torch.float32, cfg.head_dim_)
    w = build_workload("train_step", cfg, batch_size=b, seq_len=s)
    before = dict(kernels.flash_attention.route_launches)
    steps = {"plain": w.with_step(StepConfig(remat=False)),
             "flash": w.with_step(StepConfig(use_flash=True,
                                             flash_block_q=tile[0],
                                             flash_block_k=tile[1],
                                             remat=False))}
    losses = {label: float(step.fn(*w.args)[0])
              for label, step in steps.items()}
    torch.cuda.synchronize()
    after = dict(kernels.flash_attention.route_launches)
    f32_launches = after[path] - before[path]
    rel = abs(losses["flash"] / losses["plain"] - 1.0)
    print(f"{cfg.name} {cfg.n_layers}-layer loss in float32: use_flash=1 "
          f"{losses['flash']:.7f} vs use_flash=0 {losses['plain']:.7f} "
          f"(relative {rel:.3e}, tol {rtol}); f32 flash kernel ({path}) "
          f"launches {f32_launches}")
    if not (math.isfinite(rel) and rel <= rtol):
        fail(f"model step f32 ({cfg.name}): flash loss {losses['flash']} "
             f"vs plain {losses['plain']}")
    if f32_launches != cfg.n_layers or any(
            after[r] != before[r] for r in after if r != path):
        fail(f"model step f32 ({cfg.name}): flash launches per route went "
             f"from {before} to {after}, want {cfg.n_layers} on {path}")
    step_ms = {}
    for label, step in steps.items():
        times = []
        for _ in range(F32_STEP_REPEATS):
            t0 = time.perf_counter()
            step.fn(*w.args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms[label] = statistics.median(times)
    print(f"{cfg.name} {cfg.n_layers}-layer train step in float32, median "
          f"of {F32_STEP_REPEATS}: use_flash=1 {step_ms['flash']:.2f} ms, "
          f"use_flash=0 {step_ms['plain']:.2f} ms")
    del w, steps
    gc.collect()
    torch.cuda.empty_cache()
    return {"f32_loss_rel": rel, "f32_route": path,
            "f32_launches": f32_launches, "f32_step_ms": step_ms}


def gemma_f32_step(tile: tuple[int, int]) -> dict:
    """Phase 6b: gemma-2b's train step in float32 at GEMMA_F32_STEP (full
    width, 2 of 18 layers), the path that launches the f32 flash kernel at
    D = 256: ``f32_loss`` at ``tile`` (phase 6's), which holds the
    ``use_flash=1`` loss to the plain step's within F32_LOSS_RTOL and
    requires one ``tf32x3_d256`` launch a layer and none on another
    route."""
    import dataclasses
    from repro_torch.configs import get
    full = get(GEMMA_F32_STEP["arch"])
    cfg = dataclasses.replace(full, n_layers=GEMMA_F32_STEP["layers"])
    b, s = GEMMA_F32_STEP["batch"], GEMMA_F32_STEP["seq"]
    print(f"{full.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_kv_heads} kv head, head_dim "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}) in "
          f"float32; depth cut from {full.n_layers} to {cfg.n_layers} "
          f"layers ({cfg.n_params() / 1e6:.1f}M params); B={b}, S={s}; "
          f"flash tile {tile}")
    return f32_loss(cfg, b, s, tile, F32_LOSS_RTOL)


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
    gen = torch.Generator(device=ops[0].device).manual_seed(6)
    g = torch.randn(ops[0].shape, device=ops[0].device, generator=gen)
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
    """Work, bytes, bounds and blocks of one kernel call at (B, H, C, Q,
    P, N), returning the final state (the prefill path's call). ``flops``
    is the JAX package's formula, the rate's work term; the bounds count
    only the work the function needs (``needed_flops``: C·Bᵀ once for all
    heads, the causal triangle of the quadratic terms): ``bound`` at the
    rate of f32-accurate products on the tensor cores (TF32X3_PEAK, the
    least time for this work at f32 accuracy), ``bound_cuda_cores`` at the
    CUDA cores' F32_PEAK. ``blocks``: each kernel's grid (``ops.grid``);
    ``items``: the persistent kernels' work items (``ops.work_items``)."""
    from repro_torch.kernels.ssd import (bytes_moved, flops, grid,
                                         needed_flops, work_items)
    b, h, c, q, p, n = shape
    work = needed_flops(b, h, c * q, q, p, n)
    moved = bytes_moved(b, h, c * q, q, p, n, return_state=True)

    def bound(peak: float) -> tuple[float, str]:
        return (max(work / peak, moved / HBM_PEAK) * 1e3,
                "operations" if work / peak >= moved / HBM_PEAK else "bytes")
    (tc, tc_by), (cc, cc_by) = bound(TF32X3_PEAK), bound(F32_PEAK)
    return {"flops": flops(b, h, c * q, q, p, n), "needed": work,
            "bytes": moved, "bound": tc, "bound_by": tc_by,
            "bound_cuda_cores": cc, "bound_by_cuda_cores": cc_by,
            "blocks": {name: x * y for name, (x, y)
                       in grid(b, h, c, q, p, n).items()},
            "items": work_items(b, h, c, q, p, n)}


def start_baseline_build(nvcc: str, source: str, name: str):
    """Start compiling a design the shipped kernels replaced
    (``csrc/baseline/<source>``, outside the kernel library) into a
    library of its own, ``<name>``; returns (process, path)."""
    from repro_torch.kernels import build
    src = build.CSRC / "baseline" / source
    out = build.BUILD_ROOT.parent / "baselines" / (
        build.source_hash() + "_" + name)
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-shared", "-o",
                             str(out), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


def ssd_baseline_fn(lib_path):
    """The mma.sync design's launcher as a function of the kernel-layout
    operands (dense, no h0), returning (y, final state): the time the
    shipped kernel is compared with (``was_ms``), never a path of the
    port."""
    import torch
    from repro_torch.kernels import build
    fn = ctypes.CDLL(str(lib_path)).rt_ssd_chunk_scan_f32
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 6
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(xdt, bm, cm, cum):
        b, h, c, q, p = xdt.shape
        n = bm.shape[-1]
        y = torch.empty_like(xdt)
        h_out = xdt.new_empty((b, h, p, n))
        scores = xdt.new_empty((b, c, q, q))
        states = xdt.new_empty((b, h, c, p, n))
        rc = fn(xdt.data_ptr(), bm.data_ptr(), cm.data_ptr(), cum.data_ptr(),
                None, y.data_ptr(), h_out.data_ptr(), scores.data_ptr(),
                states.data_ptr(), b, h, c, q, p, n, xdt.device.index,
                build.current_stream_ptr(xdt.device.index))
        if rc != 0:
            fail(f"the mma.sync SSD baseline failed to launch: CUDA error "
                 f"{rc}")
        return y, h_out
    return run


def cuda_core_flash(d: int):
    """The f32 CUDA-core flash kernel's launcher at head dim ``d`` as a
    function of causal (B, H, S, D) q and (B, Hkv, S, D) k/v on the card
    (S a multiple of the logical block) and the logical (bq, bk): the
    design the 3xTF32 kernels replaced, timed beside them (``was_ms``, at
    D = 64 and 256) and on no path of the port. Bypasses the wrapper, so
    it counts no launch."""
    import torch
    from repro_torch.kernels import build
    fn = build.kernel_fn(f"rt_flash_attention_f32_d{d}", (
        (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 7
        + (ctypes.c_int, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p)))

    def run(q, k, v, bq, bk):
        b, h, s, _ = q.shape
        o = torch.empty_like(q)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
                k.shape[1], s, s, bq, bk, 1, 0, 1.0 / math.sqrt(d),
                q.device.index, build.current_stream_ptr(q.device.index))
        if rc != 0:
            fail(f"the CUDA-core flash kernel failed to launch: CUDA error "
                 f"{rc}")
        return o
    return run


def baseline_gemm(lib_path, dtype, tile: tuple[int, int, int]):
    """The replaced CUDA-core GEMM's launcher (``csrc/baseline/
    matmul_cuda_cores.cu``, its own library at ``lib_path``) for ``dtype``
    at ``tile`` (a tile of ``TILES``) as a function of (m, k) and (k, n)
    operands on the card: the design the f32 and bf16 kernels replaced,
    timed beside them (``was_ms``) and on no path of the port. Bypasses
    the wrapper, so it counts no launch."""
    import torch
    from repro_torch.kernels import build
    name = "f32" if dtype == torch.float32 else "bf16"
    fn = getattr(ctypes.CDLL(str(lib_path)),
                 f"rt_matmul_{name}_{tile[0]}x{tile[1]}x{tile[2]}")
    fn.argtypes = ((ctypes.c_void_p,) * 3 + (ctypes.c_int64,) * 3
                   + (ctypes.c_int, ctypes.c_void_p))
    fn.restype = ctypes.c_int

    def run(a, b):
        m, k = a.shape
        n = b.shape[1]
        c = torch.empty((m, n), dtype=a.dtype, device=a.device)
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                a.device.index, build.current_stream_ptr(a.device.index))
        if rc != 0:
            fail(f"the CUDA-core {name} GEMM failed to launch: CUDA error "
                 f"{rc}")
        return c
    return run


def bf16_gemm(a, b, tile):
    """The GEMM wrapper's launch on bf16 operands at ``tile``, which must
    count one launch, on the tensor-core route and none on the CUDA-core
    one."""
    import torch
    from repro_torch.kernels.matmul import matmul
    before, routes = matmul.launches, dict(matmul.route_launches)
    got = matmul(a, b, bm=tile[0], bn=tile[1], bk=tile[2])
    torch.cuda.synchronize()
    if matmul.launches != before + 1 or \
            matmul.route_launches["tensor_cores"] != \
            routes["tensor_cores"] + 1:
        fail(f"matmul bf16 {tile}: no launch on the tensor-core route")
    if matmul.route_launches["cuda_cores"] != routes["cuda_cores"]:
        fail(f"matmul bf16 {tile}: a launch on the CUDA-core route")
    return got


def bf16_gemm_checks(randn) -> tuple[int, float]:
    """Phase 3's bf16 GEMM checks: the tensor-core kernel against
    ``matmul_ref`` at every tile of ``BF16_TILES`` at GEMM_MAIN, at
    GEMM_SMALL and at GEMM_BF16_EDGES, every launch on the tensor-core
    route. Returns the checks made and the largest error."""
    import torch
    from repro_torch.kernels.matmul import BF16_TILES, matmul_ref
    shapes = [("main", GEMM_MAIN)] + [("small", s) for s in GEMM_SMALL] \
        + list(GEMM_BF16_EDGES.items())
    n_checks, err = 0, 0.0
    for label, (m, n, k) in shapes:
        a = randn(m, k, dtype=torch.bfloat16)
        b = randn(k, n, dtype=torch.bfloat16)
        want = matmul_ref(a, b)
        worst = 0.0
        for tile in BF16_TILES:
            worst = max(worst, check_close(
                f"matmul {m}x{n}x{k} bf16 tile {tile}", bf16_gemm(a, b, tile),
                want, gemm_tol(torch.bfloat16, k)))
            n_checks += 1
        err = max(err, worst)
        print(f"matmul {m}x{n}x{k} bf16 ({label}): {len(BF16_TILES)} "
              f"tensor-core tiles ok, max abs err {worst:.3e} (tol "
              f"{gemm_tol(torch.bfloat16, k)})")
    return n_checks, err


def bf16_gemm_times(randn, was_lib) -> dict:
    """Phase 4's bf16 GEMM at GEMM_MAIN: the tensor-core kernel at every
    tile of ``BF16_TILES`` (each checked against ``matmul_ref`` first),
    beside its bound, its plain version, ``torch.matmul`` on the same
    operands and the CUDA-core bf16 instantiation it replaced at every
    tile of ``TILES`` (its best checked too), from the baseline library
    ``was_lib``."""
    import torch
    from repro_torch.kernels.matmul import (BF16_TILES, TILES, matmul,
                                            matmul_ref)
    m, n, k = GEMM_MAIN
    a = randn(m, k, dtype=torch.bfloat16)
    b = randn(k, n, dtype=torch.bfloat16)
    tol = gemm_tol(torch.bfloat16, k)
    want = matmul_ref(a, b)
    flops = 2.0 * m * n * k
    bound_ops = flops / BF16_PEAK * 1e3
    bound_bytes = 2.0 * (m * k + k * n + m * n) / HBM_PEAK * 1e3
    tile_ms, err = {}, 0.0
    cuda_cores = matmul.route_launches["cuda_cores"]
    for tile in BF16_TILES:
        err = max(err, check_close(f"matmul bf16 timed tile {tile}",
                                   bf16_gemm(a, b, tile), want, tol))
        tile_ms[tile] = cuda_ms(
            lambda t=tile: matmul(a, b, bm=t[0], bn=t[1], bk=t[2]), iters=20)
        print(f"matmul bf16 tile {tile}: {tile_ms[tile]:.4f} ms  "
              f"{flops / tile_ms[tile] / 1e9:.2f} TFLOP/s")
    if matmul.route_launches["cuda_cores"] != cuda_cores:
        fail("the bf16 GEMM timing launched on the CUDA-core route")
    best = min(tile_ms, key=tile_ms.get)
    was_ms = {}
    for tile in TILES:
        run = baseline_gemm(was_lib, torch.bfloat16, tile)
        was_ms[tile] = cuda_ms(lambda r=run: r(a, b), iters=5, warmup=1)
    was_tile = min(was_ms, key=was_ms.get)
    was_err = check_close(f"matmul bf16 CUDA-core tile {was_tile}",
                          baseline_gemm(was_lib, torch.bfloat16, was_tile)(
                              a, b), want, tol)
    plain = cuda_ms(lambda: matmul_ref(a, b), iters=10)
    library = cuda_ms(lambda: torch.matmul(a, b), iters=20)
    ms = tile_ms[best]
    print(f"matmul {m}x{n}x{k} bf16: tensor-core kernel {ms:.4f} ms (tile "
          f"{best}, {flops / ms / 1e9:.2f} TFLOP/s, {bound_ops / ms:.1%} of "
          f"its bound) | bound {max(bound_ops, bound_bytes):.4f} ms (2mnk / "
          f"989 TFLOP/s; bytes {bound_bytes:.4f}) | plain {plain:.4f} ms | "
          f"torch.matmul {library:.4f} ms (kernel {ms / library:.3f}x) | was "
          f"{was_ms[was_tile]:.4f} ms (CUDA cores, tile {was_tile}, max abs "
          f"err {was_err:.3e}; {was_ms[was_tile] / ms:.2f}x)")
    return {"ms": ms, "tile": best, "tile_ms": tile_ms, "err": err,
            "plain": plain, "library": library,
            "bound": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "was": was_ms[was_tile], "was_tile": was_tile,
            "was_err": was_err}


def f32_gemm(a, b, tile):
    """The GEMM wrapper's launch on f32 operands at ``tile``, which must
    count one launch, on the CUDA-core route and none on the tensor-core
    one."""
    import torch
    from repro_torch.kernels.matmul import matmul
    before, routes = matmul.launches, dict(matmul.route_launches)
    got = matmul(a, b, bm=tile[0], bn=tile[1], bk=tile[2])
    torch.cuda.synchronize()
    if matmul.launches != before + 1 or \
            matmul.route_launches["cuda_cores"] != routes["cuda_cores"] + 1:
        fail(f"matmul f32 {tile}: no launch on the CUDA-core route")
    if matmul.route_launches["tensor_cores"] != routes["tensor_cores"]:
        fail(f"matmul f32 {tile}: a launch on the tensor-core route")
    return got


def f32_gemm_build(lib, ptxas_rows: list) -> dict:
    """Phase 2's f32 GEMM report: the library's tile table must be the
    wrapper's ``TILES`` and each tile's dynamic shared memory the
    wrapper's formula; per tile its threads, registers (at launch and a
    consumer's), spills, shared memory, blocks and consumer warps an SM.
    Fails on a spill. Returns {tile: info}."""
    from repro_torch.kernels.matmul import TILES, smem_bytes
    table = (ctypes.c_int * 300)()
    n_tiles = lib.rt_matmul_f32_sm90_tiles(table, 100)
    if [tuple(table[3 * i:3 * i + 3]) for i in range(n_tiles)] != \
            list(TILES):
        fail("the library's f32 GEMM tiles are not the wrapper's TILES")
    lib.rt_matmul_f32_sm90_smem_bytes.restype = ctypes.c_int64
    out, bad = {}, []
    for t in TILES:
        smem = lib.rt_matmul_f32_sm90_smem_bytes(*t)
        if smem != smem_bytes(*t):
            fail(f"matmul f32 {t}: the library asks {smem} bytes of shared "
                 f"memory, the wrapper's formula {smem_bytes(*t)}")
        info = (ctypes.c_int64 * 7)()
        rc = lib.rt_matmul_f32_sm90_info(*t, info)
        if rc != 0:
            fail(f"matmul f32 {t}: info query failed: CUDA error {rc}")
        threads, consumers, smem, regs, consumer_regs, blocks, min_blocks = \
            list(info)
        label = f"matmul_f32_sm90_kernel<f32,{t[0]},{t[1]},{t[2]}>: "
        rows = [row.split(label, 1)[1] for row in ptxas_rows if label in row]
        bad += [f"{label}{row}" for row in rows
                if ", 0 bytes spill stores" not in row]
        if not rows:
            bad.append(f"{label}not in the build log")
        warps = blocks * consumers // 32
        out[t] = {"threads": threads, "consumers": consumers,
                  "smem_bytes": smem, "registers": regs,
                  "consumer_registers": consumer_regs,
                  "blocks_per_sm": blocks, "min_blocks": min_blocks,
                  "consumer_warps_per_scheduler": warps / 4,
                  "ptxas": "; ".join(rows)}
        print(f"  matmul f32 {'x'.join(map(str, t))}: {threads} threads "
              f"({consumers} consumers), {smem} bytes dynamic shared memory, "
              f"{regs} registers at launch ({consumer_regs} a consumer), "
              f"{blocks} blocks an SM (launch bounds ask {min_blocks}), "
              f"{warps / 4:g} consumer warps a scheduler; "
              + ("; ".join(rows) or "not in the build log"))
    if bad:
        fail(f"the f32 GEMM spills: {bad}")
    return out


def f32_gemm_checks(randn, was_lib) -> tuple[int, float]:
    """Phase 3's f32 GEMM checks: the kernel against ``matmul_ref`` at
    every tile of ``TILES`` at GEMM_MAIN and at every GEMM_SMALL shape,
    every launch on the CUDA-core route; at GEMM_MAIN every tile's C must
    equal the replaced design's (``was_lib``) bit for bit, since both sum
    each output as one fmaf chain in increasing k. Returns the checks made
    and the largest error."""
    import torch
    from repro_torch.kernels.matmul import TILES, matmul_ref
    n_checks, err = 0, 0.0
    for label, (m, n, k) in [("main", GEMM_MAIN)] + [
            ("small", s) for s in GEMM_SMALL]:
        a, b = randn(m, k), randn(k, n)
        want = matmul_ref(a, b)
        was = baseline_gemm(was_lib, torch.float32, DEFAULT_F32_TILE)(a, b) \
            if label == "main" else None
        worst = 0.0
        for tile in TILES:
            got = f32_gemm(a, b, tile)
            if was is not None and not torch.equal(got, was):
                n_diff = int((got != was).sum())
                fail(f"matmul {m}x{n}x{k} f32 tile {tile}: {n_diff} elements "
                     f"differ from the replaced design's C")
            worst = max(worst, check_close(
                f"matmul {m}x{n}x{k} f32 tile {tile}", got, want,
                gemm_tol(torch.float32, k)))
            n_checks += 1
        err = max(err, worst)
        print(f"matmul {m}x{n}x{k} f32 ({label}): {len(TILES)} tiles ok, max "
              f"abs err {worst:.3e} (tol {gemm_tol(torch.float32, k)})"
              + ("; bitwise equal to the replaced design's C" if was is not
                 None else ""))
    return n_checks, err


def f32_gemm_times(randn, was_lib) -> dict:
    """Phase 4's f32 GEMM at GEMM_MAIN: the kernel and the CUDA-core
    design it replaced (``was_lib``) at every tile of ``TILES``, in turns
    tile by tile, beside the bound, the plain version and ``torch.matmul``
    with TF32 off; and the host microseconds of one launch at 128³
    through the wrapper (its checks, the tensor maps, the ctypes call)
    and through the replaced design's launcher (no tensor map)."""
    import torch
    from repro_torch.kernels.matmul import TILES, matmul, matmul_ref
    m, n, k = GEMM_MAIN
    a, b = randn(m, k), randn(k, n)
    flops = 2.0 * m * n * k
    bound_ops = flops / F32_PEAK * 1e3
    bound_bytes = 4.0 * (m * k + k * n + m * n) / HBM_PEAK * 1e3
    bound = max(bound_ops, bound_bytes)
    tile_ms, was_ms = {}, {}
    for tile in TILES:
        was = baseline_gemm(was_lib, torch.float32, tile)
        tile_ms[tile] = cuda_ms(
            lambda t=tile: matmul(a, b, bm=t[0], bn=t[1], bk=t[2]), iters=10)
        was_ms[tile] = cuda_ms(lambda r=was: r(a, b), iters=10)
        print(f"matmul f32 tile {tile}: {tile_ms[tile]:.4f} ms "
              f"{flops / tile_ms[tile] / 1e9:.2f} TFLOP/s "
              f"({bound_ops / tile_ms[tile]:.1%} of bound) | was "
              f"{was_ms[tile]:.4f} ms ({was_ms[tile] / tile_ms[tile]:.3f}x)")
    best = min(tile_ms, key=tile_ms.get)
    was_tile = min(was_ms, key=was_ms.get)
    plain = cuda_ms(lambda: matmul_ref(a, b), iters=10)
    library = cuda_ms(lambda: torch.matmul(a, b), iters=10)
    ms = tile_ms[best]
    sa, sb = randn(128, 128), randn(128, 128)
    was_small = baseline_gemm(was_lib, torch.float32, DEFAULT_F32_TILE)
    host_us = host_us_per_call(lambda: matmul(sa, sb))
    was_host_us = host_us_per_call(lambda: was_small(sa, sb))
    print(f"matmul {m}x{n}x{k} f32: kernel {ms:.4f} ms (tile {best}, "
          f"{flops / ms / 1e9:.2f} TFLOP/s, {bound_ops / ms:.1%} of its "
          f"bound) | bound {bound:.4f} ms (2mnk / 67 TFLOP/s; bytes "
          f"{bound_bytes:.4f}) | plain {plain:.4f} ms | torch.matmul (TF32 "
          f"off) {library:.4f} ms (kernel {ms / library:.3f}x) | was "
          f"{was_ms[was_tile]:.4f} ms (tile {was_tile}; "
          f"{was_ms[was_tile] / ms:.3f}x) | host us a launch at 128^3: "
          f"{host_us:.2f} (wrapper, tensor maps), {was_host_us:.2f} (the "
          f"replaced launcher)")
    return {"ms": ms, "tile": best, "tile_ms": tile_ms, "was_ms": was_ms,
            "was": was_ms[was_tile], "was_tile": was_tile, "plain": plain,
            "library": library, "bound": bound,
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "host_us": host_us, "was_host_us": was_host_us}


def serving_path() -> dict:
    """mamba2-130m at full width and depth: one prefill of a batch of
    SERVING["batch"] prompts of SERVING["seq"] tokens through
    ``api.prefill_fn``, then greedy decode steps through
    ``api.decode_fn``, then the same decode eager against captured
    (:func:`replayed_decode`). Requires one SSD launch per layer in the
    prefill, finite logits and tokens in the vocabulary."""
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
          f"tokens/s); decode {decode_ms:.3f} ms per step of {b} tokens "
          f"(eager, api.decode_fn); peak memory {peak / 2 ** 30:.2f} GiB; "
          f"launches {serving_launches}; first generated tokens "
          f"{gen_tokens[:, :8].tolist()}")
    replayed = replayed_decode({"params": params, "cfg": cfg, "step": step,
                                "batch": {"tokens": tok}, "cache": cache,
                                "pos": s + steps - 1, "logits": logits})
    del params, cache, logits
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "peak_gib": peak / 2 ** 30,
            "launches": serving_launches["ssd_chunk_scan"], **replayed}


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


class ServeWatch:
    """Inside the ``with`` block, wraps ``api.prefill_fn`` and
    ``api.decode_fn`` (the entry points ``launch.serve`` calls) to keep
    the last prefill's logits and the last decode call's weights, batch
    (the image embeddings of a VLM), cache, position and logits: what a
    ``serve`` call leaves behind, for the checks and the replayed decode.
    The wrapped calls are unchanged."""

    def __enter__(self) -> "ServeWatch":
        from repro_torch.models import api
        self.api, self.calls = api, (api.prefill_fn, api.decode_fn)
        prefill_fn, decode_fn = self.calls

        def prefill(*args):
            out = prefill_fn(*args)
            self.prefill_logits = out[0]
            return out

        def decode(params, batch, cache, pos, cfg, step):
            logits, cache = decode_fn(params, batch, cache, pos, cfg, step)
            self.last = {"params": params, "cache": cache, "pos": pos,
                         "logits": logits, "cfg": cfg, "step": step,
                         "batch": batch}
            return logits, cache

        api.prefill_fn, api.decode_fn = prefill, decode
        return self

    def __exit__(self, *exc) -> None:
        self.api.prefill_fn, self.api.decode_fn = self.calls


def named_leaves(tree: dict, prefix: str = ""):
    """(path, leaf) of every leaf of nested dicts, paths ``key/subkey``."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from named_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def kv_layers(cfg) -> int:
    """The layers of ``cfg``'s self-attention KV cache, as
    ``api.cache_shapes`` lays it out."""
    from repro_torch.models import api
    from repro_torch.models.config import WorkloadShape
    tree = api.cache_shapes(cfg, WorkloadShape("kv", 1, 1, "decode"))
    return tree["attn"]["k"].shape[0]


def cache_shapes_served(cfg, batch: int, length: int) -> dict:
    """``api.cache_shapes`` of ``batch`` sequences of ``length`` tokens
    as (path -> (shape, dtype)). The attention caches are ``length``
    long past a sliding window too: serving grows the prefill's cache by
    the generated tokens."""
    import dataclasses
    from repro_torch.models import api
    from repro_torch.models.config import WorkloadShape
    tree = api.cache_shapes(dataclasses.replace(cfg, window=None),
                            WorkloadShape("served", length, batch, "decode"))
    return {path: (tuple(leaf.shape), leaf.dtype)
            for path, leaf in named_leaves(tree)}


def served(spec: dict) -> dict:
    """One model at full width through ``serve`` (SERVE, STACK_SERVE): a
    warm-up serve, then the timed one, with the launch counts set to 0
    just before it and read just after. With ``spec["layers"]`` the depth
    is cut: the weights are materialized once for the cut config and
    both runs go through ``launch.serve.generate`` with ``serve``'s
    prompt and inputs. Requires finite prefill and decode logits, every
    generated token in the vocabulary, no flash launch (the reference's
    prefill is plain attention), and for a model with Mamba2 layers one
    SSD launch per layer, and every leaf of the last decode step's cache
    in the shape and dtype ``api.cache_shapes`` gives B sequences of
    prompt + gen tokens (:func:`cache_shapes_served`)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get
    from repro_torch.launch.serve import generate, serve, serve_inputs
    from repro_torch.models import api
    from repro_torch.models.params import materialize
    full = get(spec["arch"])
    cfg = dataclasses.replace(full, n_layers=spec.get("layers",
                                                      full.n_layers))
    b, s, gen = spec["batch"], spec["prompt"], spec["gen"]
    if "layers" in spec:
        params = materialize(torch.Generator(device="cuda").manual_seed(0),
                             api.param_defs(cfg))
        rng = np.random.default_rng(1)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (b, s))).cuda()
        inputs = serve_inputs(cfg, b, rng, torch.device("cuda"))

        def run(prompt_len: int, n: int) -> dict:
            out = generate(params, prompt[:, :prompt_len], cfg, n,
                           inputs=inputs)
            return {"tokens": out["tokens"].cpu().numpy(),
                    "prefill_s": out["prefill_s"],
                    "decode_s_per_token": out["decode_s"] / max(n - 1, 1)}
    else:
        def run(prompt_len: int, n: int) -> dict:
            return serve(spec["arch"], batch=b, prompt_len=prompt_len,
                         gen=n, smoke=False)
    run(SERVE_WARMUP["prompt"], SERVE_WARMUP["gen"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with ServeWatch() as watch:
        result = run(s, gen)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    state = watch.last
    tokens = result["tokens"]
    want_ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    if launches["ssd_chunk_scan"] != want_ssd or launches["flash_attention"]:
        fail(f"serve {cfg.name}: launches {launches}, want "
             f"ssd_chunk_scan={want_ssd} (one per Mamba2 layer in the "
             f"prefill) and no flash launch")
    for name, t in (("prefill", watch.prefill_logits),
                    ("decode", state["logits"])):
        if not bool(torch.isfinite(t).all()):
            fail(f"serve {cfg.name}: non-finite {name} logits")
    if tokens.shape != (b, gen) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        fail(f"serve {cfg.name}: tokens {tokens.shape} outside the "
             f"vocabulary of {cfg.vocab_size}")
    cache = state["cache"]
    want = cache_shapes_served(cfg, b, s + gen)
    leaves = dict(named_leaves(cache))
    got = {k: (tuple(t.shape), t.dtype) for k, t in leaves.items()}
    if got != want:
        fail(f"serve {cfg.name}: cache {got}, want {want}")
    prefill_ms = result["prefill_s"] * 1e3
    decode_ms = result["decode_s_per_token"] * 1e3
    depth = (f"{cfg.n_layers} of {full.n_layers} layers (depth cut)"
             if cfg.n_layers != full.n_layers else
             f"all {cfg.n_layers} layers")
    extra = "".join(f", {k} {tuple(v.shape)}" for k, v in
                    state["batch"].items() if k != "tokens")
    print(f"{cfg.name}: {depth} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_kv_heads} kv heads of "
          f"{cfg.head_dim_}, window {cfg.window}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}; {cfg.n_params() / 1e9:.3f}B params); "
          f"{'generate' if 'layers' in spec else 'serve'}(batch={b}, "
          f"prompt_len={s}, gen={gen}{extra}): prefill {prefill_ms:.1f} ms "
          f"({b * s / result['prefill_s']:.0f} tokens/s), decode "
          f"{decode_ms:.3f} ms per step of {b} tokens (captured from the "
          f"second step: the eager warm-up and the capture included), "
          f"peak memory "
          f"{peak / 2 ** 30:.2f} GiB; cache "
          + ", ".join(f"{k} {shape} {str(dt).replace('torch.', '')}"
                      for k, (shape, dt) in got.items())
          + f"; launches "
          f"{launches}; first tokens {tokens[:, :8].tolist()}")
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "tokens_per_s": b * s / result["prefill_s"],
            "peak_gib": peak / 2 ** 30, "launches": launches,
            "state": state}


def replayed_decode(state: dict, steps: int = GRAPH_STEPS) -> dict:
    """``steps`` greedy decode steps from the cache a ``serve`` call left,
    each run from its own copy of the cache: through
    ``launch.serve.greedy_decode`` (the loop ``generate`` runs) eagerly,
    under ``graphs.disabled()``, and as the package runs it on the card
    (the first step eager, the second captured in a CUDA graph, the rest
    replayed), whose tokens must be the eager loop's; then the same step
    through ``graphs.captured`` as ``greedy_decode`` calls it, warmed up
    and captured before the clock starts, to time the replays alone (its
    tokens must be the eager ones too). Returns the eager ms per step and
    the host's enqueue time, greedy_decode's ms per step whole (warm-up
    and capture included), a replayed step's ms, and each run's peak
    memory."""
    import contextlib
    import torch
    from repro_torch import graphs
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models import api
    from repro_torch.models.params import map_tree
    params, cfg, step = state["params"], state["cfg"], state["step"]
    vocab = cfg.vocab_size
    inputs = {k: v for k, v in state["batch"].items() if k != "tokens"}
    with torch.no_grad():
        cache0 = api.extend_cache(state["cache"], steps)
        pos0 = int(state["pos"]) + 1
        logits0 = state["logits"].clone()

    def fresh() -> dict:
        return map_tree(lambda _, t: t.clone(), cache0)

    runs = {}
    for label in ("eager", "generate"):
        cache = fresh()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with graphs.disabled() if label == "eager" else \
                contextlib.nullcontext():
            out = greedy_decode(params, logits0, cache, pos0, steps, cfg,
                                step, inputs=inputs)
        # the host's clock before the synchronize: how long it took to
        # enqueue the steps, against the time until the card is done
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / steps
        torch.cuda.synchronize()
        runs[label] = {"tokens": out["tokens"][:, 1:], "enqueue_ms": enqueue_ms,
                       "ms": (time.perf_counter() - t0) * 1e3 / steps,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del cache, out

    def decode_step(params, batch, cache, pos):
        return api.decode_fn(params, batch, cache, pos, cfg, step)

    decode = graphs.captured(decode_step, donate_argnums=(2,),
                             device_scalars=(3,))
    cache, tok, replayed = fresh(), logits0[:, -1:, :vocab].argmax(-1), []
    with torch.no_grad():
        for i in range(steps):
            if i == 2:        # after the warm-up and the capture
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            logits, cache = decode(params, {"tokens": tok, **inputs}, cache,
                                   pos0 + i)
            tok = logits[:, -1:, :vocab].argmax(-1)
            replayed.append(tok)
        torch.cuda.synchronize()
        graph_ms_ = (time.perf_counter() - t0) * 1e3 / (steps - 2)
    decode.release()
    eager_t = runs["eager"]["tokens"]
    for label, got in (("generate's decode loop", runs["generate"]["tokens"]),
                       ("the replayed step", torch.cat(replayed, dim=1))):
        if not torch.equal(eager_t, got):
            fail(f"{cfg.name}: {label}'s tokens {got[:, :8].tolist()} "
                 f"differ from the eager loop's {eager_t[:, :8].tolist()}")
    eager_ms = runs["eager"]["ms"]
    print(f"{cfg.name} decode from position {pos0}, {steps} steps of "
          f"{eager_t.shape[0]} tokens through launch.serve.greedy_decode: "
          f"eager {eager_ms:.3f} ms per step (the host enqueued it in "
          f"{runs['eager']['enqueue_ms']:.3f}), peak "
          f"{runs['eager']['peak_gib']:.2f} GiB; captured as generate runs "
          f"it {runs['generate']['ms']:.3f} ms per step (its eager warm-up "
          f"and capture included), peak {runs['generate']['peak_gib']:.2f} "
          f"GiB; a replayed step alone {graph_ms_:.3f} ms (same tokens; the "
          f"card idle {1 - graph_ms_ / eager_ms:.1%} of an eager step)")
    del cache, cache0
    torch.cuda.empty_cache()
    return {"eager_ms": eager_ms, "enqueue_ms": runs["eager"]["enqueue_ms"],
            "generate_ms": runs["generate"]["ms"], "graph_ms": graph_ms_,
            "eager_peak_gib": runs["eager"]["peak_gib"],
            "graph_peak_gib": runs["generate"]["peak_gib"]}


def long_context_decode(state: dict) -> dict:
    """granite-3-2b decode at decode_32k's context (LONG_DECODE): a cache
    of B x (context + steps) slots whose first ``context`` slots hold
    seeded random K/V tagged 0..context-1, then ``steps`` greedy
    ``decode_fn`` steps from position ``context``. Requires finite logits
    and tokens in the vocabulary; ms per step and peak memory."""
    import numpy as np
    import torch
    from repro_torch.models import api
    from repro_torch.models.transformer import kv_cache_spec
    params, cfg, step = state["params"], state["cfg"], state["step"]
    b, ctx, steps = (LONG_DECODE["batch"], LONG_DECODE["context"],
                     LONG_DECODE["steps"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    attn = kv_cache_spec(cfg, b, ctx + steps).init_tree("cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    attn["k"][..., :ctx, :].normal_(generator=gen)
    attn["v"][..., :ctx, :].normal_(generator=gen)
    attn["pos"][..., :ctx] = torch.arange(ctx, dtype=torch.int32,
                                          device="cuda")
    kv_gb = 2 * attn["k"].numel() * attn["k"].element_size() / 1e9
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (b, 1))).cuda()
    cache, generated = {"attn": attn}, []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = api.decode_fn(params, {"tokens": tok}, cache,
                                          ctx + i, cfg, step)
            tok = logits[..., :cfg.vocab_size].argmax(dim=-1)
            generated.append(tok)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated()
    tokens = torch.cat(generated, dim=1)
    if not bool(torch.isfinite(logits).all()) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        fail(f"{cfg.name} decode at context {ctx}: non-finite logits or "
             f"tokens outside the vocabulary")
    dtype = str(attn["k"].dtype).replace("torch.", "")
    print(f"{cfg.name} decode at context {ctx} (KV cache "
          f"{tuple(attn['k'].shape)} {dtype}, {kv_gb:.2f} GB of K and V): "
          f"{ms:.3f} ms per step of {b} tokens ({steps} steps, eager), peak "
          f"memory {peak / 2 ** 30:.2f} GiB")
    del cache, attn
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_gib": peak / 2 ** 30, "kv_gb": kv_gb}


class RouteWatch:
    """Inside the ``with`` block, wraps ``repro_torch.models.moe.route``
    to keep, for every routing call, the smallest gap between a token's
    k-th and (k+1)-th router logit: how close a routing came to another
    choice. While the wrapped call runs, its ``torch.topk`` also takes a
    top-(k+1) of the same logits for the gap; the call and its result
    are unchanged."""

    def __enter__(self) -> "RouteWatch":
        import torch
        from repro_torch.models import moe
        self.moe, self.route, self.gaps = moe, moe.route, []
        topk = torch.topk

        def watched(logits, k, **kw):
            if k < logits.shape[-1]:
                top = topk(logits, k + 1, dim=-1).values
                self.gaps.append((top[..., -2] - top[..., -1]).min())
            return topk(logits, k, **kw)

        def route(p, xg, cfg):
            torch.topk = watched
            try:
                return self.route(p, xg, cfg)
            finally:
                torch.topk = topk

        moe.route = route
        return self

    def __exit__(self, *exc) -> None:
        self.moe.route = self.route

    def smallest(self) -> float:
        return min((float(g) for g in self.gaps), default=math.inf)


def serving_continues_prefill(arch: str, layers: "int | None" = None
                              ) -> dict:
    """In f32 at ``arch``'s full width cut to ``layers`` (default
    SERVE_CONTINUE's depth), B = 1: a prefill of SERVE_CONTINUE["prefill"]
    tokens, grown by and continued with SERVE_CONTINUE["decode"]
    teacher-forced decode steps, must give the last logits and every
    cache leaf of one prefill of all the tokens (position tags exactly,
    the rest within CONTINUE_TOL). Every call gets the same frames or
    image embeddings (``serve``'s inputs); for an MoE model the smallest
    top-k gap of the router logits over all of it is printed (a gap near
    the f32 rounding could flip a choice between the two paths)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.launch.serve import serve_inputs
    from repro_torch.models import api
    from repro_torch.models.params import materialize
    from repro_torch.models.transformer import StepConfig
    cfg = dataclasses.replace(
        get(arch), dtype="float32",
        n_layers=layers or SERVE_CONTINUE["layers"][arch])
    n0, n1 = SERVE_CONTINUE["prefill"], SERVE_CONTINUE["decode"]
    params = materialize(torch.Generator(device="cuda").manual_seed(0),
                         api.param_defs(cfg))
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, n0 + n1))).cuda()
    inputs = serve_inputs(cfg, 1, rng, torch.device("cuda"))
    step = StepConfig(remat=False)
    with torch.no_grad(), RouteWatch() as routes:
        logits, cache = api.prefill_fn(
            params, {"tokens": tokens[:, :n0], **inputs}, cfg, step)
        cache = api.extend_cache(cache, n1)
        for t in range(n0, n0 + n1):
            logits, cache = api.decode_fn(
                params, {"tokens": tokens[:, t:t + 1], **inputs}, cache, t,
                cfg, step)
        want_logits, want = api.prefill_fn(
            params, {"tokens": tokens, **inputs}, cfg, step)
    got_leaves = {"logits": logits, **dict(named_leaves(cache))}
    want_leaves = {"logits": want_logits, **dict(named_leaves(want))}
    if sorted(got_leaves) != sorted(want_leaves):
        fail(f"{cfg.name}: decode continuing prefill: cache leaves "
             f"{sorted(got_leaves)}, want {sorted(want_leaves)}")
    errs = {}
    for name, got_t in got_leaves.items():
        if got_t.dtype == torch.int32:
            if not torch.equal(got_t, want_leaves[name]):
                fail(f"{cfg.name}: decode continuing prefill: {name} "
                     f"differs")
            continue
        errs[name] = check_close(f"{cfg.name} decode continues prefill: "
                                 f"{name}", got_t, want_leaves[name],
                                 CONTINUE_TOL)
    gap = routes.smallest()
    print(f"f32 {cfg.name} ({cfg.n_layers} layers, full width): prefill "
          f"{n0} + {n1} decode steps vs prefill {n0 + n1}: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; position tags equal (limit {CONTINUE_TOL})"
          + (f"; smallest top-k router gap {gap:.3e}" if cfg.n_experts
             else ""))
    del params, cache, want
    torch.cuda.empty_cache()
    if cfg.n_experts:
        errs["smallest_topk_gap"] = gap
    return errs


def dense_and_hybrid_serving() -> dict:
    """granite-3-2b and zamba2-2.7b served at full width and depth
    (:func:`served`), each with its decode eager against captured
    (:func:`replayed_decode`); granite's decode at decode_32k's context
    (:func:`long_context_decode`); decode continuing prefill in f32 for
    both; and the serving CLI once on the card."""
    import torch
    out = {}
    for label, spec in SERVE.items():
        run = served(spec)
        run.update(replayed_decode(run["state"]))
        if label == "granite":
            run["long"] = long_context_decode(run["state"])
        del run["state"]
        torch.cuda.empty_cache()
        out[label] = run
    out["continue"] = {arch: serving_continues_prefill(arch)
                       for arch in SERVE_CONTINUE["layers"]}
    cli, _ = run_module("repro_torch.launch.serve",
                        ["--arch", "granite_3_2b", "--smoke", "--batch", "2",
                         "--prompt-len", "16", "--gen", "4"], "serve_cli")
    if "[serve] generated shape (2, 4)" not in cli:
        fail(f"the serving CLI printed {cli!r}")
    print("  " + cli.strip().splitlines()[0])
    return out


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
    g = torch.randn(ops[0].shape, generator=gen, device="cuda")
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
    from repro_torch.kernels.ssd import KERNELS as SSD_KERNELS
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
    parts = {"ssd kernel": named(*SSD_KERNELS),
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


def run_module(module: str, args: list[str], log: str,
               codes: tuple[int, ...] = (0,)) -> tuple[str, int]:
    """``python -m <module> <args>`` from the checkout; fails the run on an
    exit code outside ``codes``; returns its output and exit code (the
    output is also kept in ``WORK/<log>.log``)."""
    cmd = [sys.executable, "-m", module, *args]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    print("$ " + " ".join(cmd[1:]), flush=True)
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=SUBPROCESS_TIMEOUT_S)
    (WORK / f"{log}.log").write_text(proc.stdout + proc.stderr,
                                     encoding="utf-8")
    if proc.returncode not in codes:
        print(proc.stdout[-6000:])
        print(proc.stderr[-6000:], file=sys.stderr)
        fail(f"{module} {' '.join(args)} exited {proc.returncode}, want "
             f"{codes}")
    return proc.stdout, proc.returncode


def run_tune(args: list[str], session: str = "smoke",
             cache_dir: "pathlib.Path | None" = None,
             log: "str | None" = None) -> tuple[str, dict]:
    """One ``python -m repro_torch.tune`` session (cache dir
    ``WORK/sessions`` unless given); returns its output and the launch
    counts of its footer's ``kernels`` line."""
    t0 = time.perf_counter()
    out, _ = run_module(
        "repro_torch.tune",
        ["--session", session, "--cache-dir",
         str(cache_dir or WORK / "sessions"), *args],
        log or f"tune_{session}_{args[1]}")
    dt = time.perf_counter() - t0
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


def traced_session(label: str, space, settings, bench) -> dict:
    """One ``Tuner`` session under its own ``TraceRecorder``; returns the
    result and the ``device_timing`` instants of its trials."""
    from repro_torch.core import Tuner
    from repro_torch.obs import TraceRecorder
    path = WORK / "device_timing" / f"{re.sub(r'[^a-z0-9]+', '_', label)}.jsonl"
    with TraceRecorder(path, session=label) as rec:
        result = Tuner(space, settings).tune(bench)
    events = rec.events()
    unavailable = [e for e in events if e.get("name") ==
                   "device_timing_unavailable"]
    if unavailable:
        fail(f"device timing {label}: {len(unavailable)} trial(s) gave "
             f"device_timing_unavailable on the card")
    trials = {e["id"]: e.get("attrs", {}) for e in events
              if e["type"] == "span" and e.get("cat") == "trial"}
    timings = [(trials.get(e["parent"], {}).get("config"), e["attrs"])
               for e in events if e.get("name") == "device_timing"]
    if len(timings) != len(result.improvements):
        fail(f"device timing {label}: {len(timings)} device_timing "
             f"instants for {len(result.improvements)} incumbent trials")
    for config, t in timings:
        print(f"  {label} {config}: host bracket {t['host_time_s'] * 1e6:.2f}"
              f" us, device {t['device_time_s'] * 1e6:.2f} us "
              f"({t['n_events']} kernel event(s)), skew "
              f"{t['skew_s'] * 1e6:.2f} us", flush=True)
        if not (0.0 < t["device_time_s"] <= t["host_time_s"]
                and t["n_events"] >= 1):
            fail(f"device timing {label} {config}: device "
                 f"{t['device_time_s']} s, host {t['host_time_s']} s, "
                 f"{t['n_events']} events")
    return {"result": result, "timings": timings}


def device_timing_path(triad_ms: dict) -> dict:
    """Phase 10: traced sessions with ``device_timing=True`` — DGEMM over
    the card space and TRIAD at each DEVICE_TIMING_TRIAD size alone; the
    4 MiB and 256 MiB TRIAD device times against phase 4's graph-replay
    times of the same sizes."""
    import dataclasses
    from repro_torch.bench.common import (card_dgemm_space, dgemm_benchmark,
                                          paper_settings, triad_benchmark)
    from repro_torch.core import grid
    from repro_torch.obs import metrics
    from repro_torch.obs.device_timing import PRIMER
    counter = "device_timing.lost_kernel_records"
    lost_before = metrics().snapshot()["counters"].get(counter, 0)
    retries_before = metrics().snapshot()["counters"].get(
        "card_clock.retries", 0)
    settings = dataclasses.replace(paper_settings(True),
                                   use_ci_convergence=True,
                                   use_inner_prune=True,
                                   use_outer_prune=True, device_timing=True)
    out = {"dgemm": traced_session("dgemm card space", card_dgemm_space(),
                                   settings, dgemm_benchmark("cuda"))}
    # the timed sampler's score (the card's clock around the product)
    # against the profiled product's own rate
    scores = {tuple(sorted(t.config.items())): t.result.score
              for t in out["dgemm"]["result"].trials}
    for config, t in out["dgemm"]["timings"]:
        score = scores[tuple(sorted(config.items()))]
        rate = 2.0 * config["n"] * config["m"] * config["k"] / (
            t["device_time_s"] * 1e9)
        print(f"  dgemm {config}: timed-sampler score {score:.1f} GFLOP/s, "
              f"profiled kernel {rate:.1f} GFLOP/s ({score / rate - 1:+.1%})")
    # each TRIAD size is a measurement, not a competitor: no pruning
    triad_settings = dataclasses.replace(settings, use_inner_prune=False,
                                         use_outer_prune=False)
    for label, n_bytes in DEVICE_TIMING_TRIAD.items():
        run = traced_session(f"triad {n_bytes >> 10} KiB",
                             grid(n_bytes=(n_bytes,)), triad_settings,
                             triad_benchmark("cuda"))
        out[label] = run
        if label not in triad_ms:
            continue
        device_ms = run["timings"][0][1]["device_time_s"] * 1e3
        t = triad_ms[label]
        rel = device_ms / t["graph"] - 1.0
        print(f"  triad {n_bytes >> 20} MiB: profiled kernel {device_ms:.5f} "
              f"ms vs phase 4 graph replay {t['graph']:.5f} ms ({rel:+.1%}; "
              f"back-to-back launches {t['kernel']:.5f} ms)")
        if abs(rel) > DEVICE_TIMING_AGREEMENT:
            fail(f"device timing triad {label}: profiled {device_ms:.5f} ms "
                 f"is {rel:+.1%} off the CUDA-event graph replay "
                 f"{t['graph']:.5f} ms (limit {DEVICE_TIMING_AGREEMENT:.0%})")
    counters = metrics().snapshot()["counters"]
    records = counters.get(counter, 0) - lost_before
    retries = counters.get("card_clock.retries", 0) - retries_before
    windows = sum(len(run["timings"]) for run in out.values())
    print(f"  kernel records the profiler lost in the recorded step of "
          f"each window (after a warm-up step of {PRIMER} throwaway "
          f"kernels): {records} over {windows} windows; DGEMM card-clock "
          f"samples retaken with a longer hold: {retries}")
    out["lost"] = {"kernel_records": records, "windows": windows}
    return out


def finite_rows(name: str, rows: list, keys: tuple) -> None:
    if not rows:
        fail(f"paper table {name}: empty")
    for row in rows:
        for key in keys:
            value = float(row[key])
            if not (math.isfinite(value) and value > 0):
                fail(f"paper table {name}: {key}={row[key]!r} in {row}")


def paper_tables_path() -> dict:
    """Phase 11: the paper-table benches quick on the card, the harness,
    and DGEMM sessions over the card space on the serial, simulated:4 and
    process:2 backends."""
    from repro_torch import kernels
    from repro_torch.bench import harness
    from repro_torch.bench import run as bench_run
    from repro_torch.bench.common import card_dgemm_space, paper_settings
    from repro_torch.bench.optimizations import techniques

    print("$ repro_torch.bench.run --device cuda --only "
          + ",".join(PAPER_BENCHES), flush=True)
    kernels.reset_launch_counts()
    res = bench_run.run_benches(PAPER_BENCHES, quick=True, device="cuda")
    launches = kernels.launch_counts()
    routes = dict(kernels.matmul.route_launches)

    peak = res["matmul_peak"]
    finite_rows("matmul_peak", peak["rows"], ("gflops",))
    finite_rows("triad", res["triad"], ("gbytes_per_s", "samples"))
    finite_rows("iteration_counts", res["iteration_counts"],
                ("mean_iters", "min_iters", "total_samples"))
    finite_rows("size_sweep", res["size_sweep"],
                ("gflops", "eval_time_s", "samples"))
    rows = res["optimizations"]
    finite_rows("optimizations", rows, ("best_gflops", "time_s", "samples"))
    want = list(techniques(paper_settings(True))) + [
        "Hand-tuned Time", "Hand-tuned Accuracy"]
    if [r["technique"] for r in rows] != want:
        fail(f"optimizations rows {[r['technique'] for r in rows]}, want "
             f"{want}")
    for r in rows:
        for key in ("speedup", "err_raw"):
            if not math.isfinite(float(r[key].rstrip("x%"))):
                fail(f"optimizations {r['technique']}: {key} {r[key]}")
    counts = {r["technique"]: r["total_samples"]
              for r in res["iteration_counts"]}
    if not counts["C+I+O"] < counts["Default"]:
        fail(f"C+I+O took {counts['C+I+O']} samples, Default "
             f"{counts['Default']}: the optimized pipeline must take fewer")
    tile = res["kernel_autotune"]
    if not math.isfinite(tile["err"]) or tile["trials"] < 1:
        fail(f"kernel_autotune: {tile}")
    tile16 = tile["bf16"]
    if not math.isfinite(tile16["err"]) or tile16["trials"] < 1:
        fail(f"kernel_autotune bf16: {tile16}")
    if tile16["launches"]["tensor_cores"] == 0 or \
            tile16["launches"]["cuda_cores"] != 0:
        fail(f"the bf16 tile search's GEMM launches by route "
             f"{tile16['launches']}: want some on the tensor cores and none "
             f"on the CUDA cores")
    for key in ("triad", "matmul"):
        if launches[key] == 0:
            fail(f"the paper benches never launched the {key} kernel")

    print("paper tables (NVIDIA card, quick budgets):")
    print(f"  matmul peak: autotuned {peak['autotuned']:.1f} GFLOP/s at "
          f"{peak['dims']}; square {peak['square']:.1f} at "
          f"{peak['square_dims']} ({peak['square'] / peak['autotuned']:.3f}x)")
    cache = max(r["gbytes_per_s"] for r in res["triad"]
                if r["regime"] == "cache")
    dram = max(r["gbytes_per_s"] for r in res["triad"]
               if r["regime"] == "dram")
    print(f"  TRIAD peaks: cache-resident {cache:.1f} GB/s, DRAM {dram:.1f} "
          f"GB/s")
    for r in rows:
        print(f"  {r['technique']:<20s} speedup {r['speedup']:>7s}  error "
              f"raw {r['err_raw']:>6s} refined {r['err_refined']:>6s}  "
              f"samples {r['samples']}")
    print(f"  kernel_autotune: {tile['best']} at {tile['score']:.1f} GFLOP/s "
          f"over {tile['trials']} tiles, max err vs matmul_ref "
          f"{tile['err']:.2e}")
    print(f"  kernel_autotune bf16: {tile16['best']} at "
          f"{tile16['score']:.1f} GFLOP/s over {tile16['trials']} tiles, max "
          f"err vs matmul_ref {tile16['err']:.2e} (rtol/atol 3e-2); GEMM "
          f"launches by route {tile16['launches']}")

    print("$ repro_torch.bench.harness", flush=True)
    out = WORK / "harness" / "harness.json"
    rc = harness.main(["--out", str(out)])
    doc = json.loads(out.read_text(encoding="utf-8"))
    agr = doc["agreement"]
    for name, fam in doc["families"].items():
        print(f"  harness {name}: non-measured per trial legacy "
              f"{fam['legacy']['non_measured_per_trial_s'] * 1e3:.3f} ms, "
              f"fast {fam['fast']['non_measured_per_trial_s'] * 1e3:.3f} ms "
              f"({fam['speedup_non_measured']}x; target "
              f">= {harness.MIN_SPEEDUP:g}x, reported only)")
    misses = []
    if agr["rel_diff"] > harness.MAX_REL_DIFF:
        misses.append(f"harness: timed vs steady {agr} beyond "
                      f"{harness.MAX_REL_DIFF:.0%}")
    print(f"  harness exit {rc}; timed vs steady on {agr['workload']}: "
          f"timed {agr['timed_gflops']:.1f}, steady {agr['steady_gflops']:.1f}"
          f" GFLOP/s, rel diff {agr['rel_diff']:.5f} (must lie within "
          f"{harness.MAX_REL_DIFF:.0%})")

    n_configs = card_dgemm_space().cardinality
    best = {}
    for backend in ("serial", "simulated:4", "process:2"):
        name = "backend_" + backend.replace(":", "")
        tune_out, _ = run_tune(["--benchmark", "dgemm", "--backend",
                                backend], session=name)
        m = re.search(r"^trials    : (\d+)", tune_out, re.M)
        if m is None or int(m.group(1)) != n_configs:
            misses.append(f"dgemm --backend {backend}: {m and m.group(1)} "
                          f"trials, want all {n_configs} card-space configs")
            continue
        m = re.search(r"^best      : .*score=([0-9.eE+-]+)$", tune_out, re.M)
        best[backend] = float(m.group(1))
    for backend in ("simulated:4", "process:2"):
        if backend not in best or "serial" not in best:
            continue
        ratio = best[backend] / best["serial"]
        print(f"  F_p {backend} / serial = {ratio:.3f} (must lie in "
              f"{F_P_AGREEMENT})")
        if not F_P_AGREEMENT[0] <= ratio <= F_P_AGREEMENT[1]:
            misses.append(f"dgemm --backend {backend}: F_p "
                          f"{best[backend]:.1f} is {ratio:.3f}x the serial "
                          f"session's {best['serial']:.1f}")
    if misses:
        fail("; ".join(misses))
    return {"benches": res, "launches": launches, "routes": routes,
            "harness": doc, "backends": best}


def progress_lines(out: str) -> list[tuple[str, str]]:
    """(config, score or PRUNED) of each trial line a tune run printed."""
    return re.findall(r"^  \[\s*\d+/\d+\] (\{.*?\}) -> +(\S+)", out, re.M)


def best_line(out: str) -> tuple[str, float]:
    """(config, score) of a tune run's ``best`` line."""
    m = re.search(r"^best      : (\{.*\})  score=(\S+)$", out, re.M)
    if m is None:
        fail("a tune run printed no best line")
    return m.group(1), float(m.group(2))


def history_search_path(roofline_fp: float) -> dict:
    """Phase 12: the run ledger and its gate over two exhaustive
    ``gemm_tiled`` runs (then an injected 10% drop), the surrogate and
    bandit strategies, a DGEMM shape sweep with its oracle, and the HTML
    dashboard over phase 5's cache, item 1's ledger and a phase-10 trace.
    ``roofline_fp`` is phase 5's F_p, which the dashboard must show."""
    import dataclasses
    from repro_torch.core import hardware_fingerprint
    from repro_torch.history import RunLedger, detect_regressions
    from repro_torch.kernels.matmul import TILES as GEMM_TILES

    fingerprint = hardware_fingerprint("cuda")
    gate_dir = WORK / "history"
    ledger_path = gate_dir / "history.jsonl"
    launches = 0
    # 1. the gate series: two exhaustive runs of the same code
    runs = []
    for k, extra in enumerate(([], ["--fresh"])):
        out, counts = run_tune(["--benchmark", "gemm_tiled", "--history",
                                *extra], session="gate", cache_dir=gate_dir,
                               log=f"gate_run{k}")
        if counts.get("matmul", 0) == 0:
            fail(f"gate run {k}: gemm_tiled launched no GEMM kernel")
        launches += counts["matmul"]
        trials = progress_lines(out)
        if len(trials) != len(GEMM_TILES):
            fail(f"gate run {k}: {len(trials)} trials, want all "
                 f"{len(GEMM_TILES)} tiles")
        runs.append({"out": out, "best": best_line(out),
                     "trials": trials, "matmul": counts["matmul"]})
        print("  " + next(ln for ln in out.splitlines()
                          if ln.startswith("perf-gate:")))
    series = RunLedger(ledger_path).series("gemm_tiled", fingerprint)
    if len(series) != 2:
        fail(f"the ledger holds {len(series)} gemm_tiled runs, want 2")
    gate_out, _ = run_module("repro_torch.perf_gate", [str(ledger_path)],
                             "perf_gate_flat", codes=(0,))
    flat = detect_regressions(RunLedger(ledger_path),
                              benchmark="gemm_tiled").series[0].comparison
    newest = series[-1]
    RunLedger(ledger_path).append(dataclasses.replace(
        newest, score=newest.score * 0.9, mean=newest.mean * 0.9,
        invocation_means=tuple(0.9 * x for x in newest.invocation_means)))
    drop_out, _ = run_module("repro_torch.perf_gate", [str(ledger_path)],
                             "perf_gate_drop", codes=(1,))
    name = f"gemm_tiled @ {fingerprint}"
    if not any(name in ln and "REGRESSED" in ln
               for ln in drop_out.splitlines()):
        fail(f"perf_gate exited 1 but named no regressed {name!r}")
    drop = detect_regressions(RunLedger(ledger_path),
                              benchmark="gemm_tiled").series[0].comparison
    for label, c in (("two runs, same code", flat),
                     ("injected 10% drop", drop)):
        print(f"  gate {label}: {c.verdict} ({c.method}), run "
              f"{c.candidate.run} mean {c.candidate.mean:.2f} vs best run "
              f"{c.baseline.run} {c.baseline.mean:.2f} GFLOP/s, "
              f"{c.rel_delta:+.3%}, {c.confidence:.0%} CI of the difference "
              f"[{c.interval.lo:.3f}, {c.interval.hi:.3f}]")
    print("  " + gate_out.splitlines()[0])
    print("  " + drop_out.splitlines()[0])
    winner = runs[0]["best"]

    # 2. surrogate over the GEMM tiles, bandit over the card's DGEMM space
    search_dir = WORK / "search"
    out, counts = run_tune(["--benchmark", "gemm_tiled", "--strategy",
                            "surrogate", "--budget", "8", "--seed", "0"],
                           session="surrogate", cache_dir=search_dir)
    launches += counts.get("matmul", 0)
    if counts.get("matmul", 0) == 0:
        fail("the surrogate session launched no GEMM kernel")
    sur_best = best_line(out)
    sur_trials = progress_lines(out)
    found_at = 1 + [cfg for cfg, _ in sur_trials].index(sur_best[0])
    reached = next((i + 1 for i, (cfg, _) in enumerate(sur_trials)
                    if cfg == winner[0]), None)
    print(f"  surrogate: best {sur_best[0]} at {sur_best[1]:.1f} GFLOP/s, "
          f"found at trial {found_at} of {len(sur_trials)}; exhaustive "
          f"winner {winner[0]} at {winner[1]:.1f} GFLOP/s (12 trials) "
          + (f"proposed at trial {reached}" if reached else
             "not proposed within the budget"))
    out, _ = run_tune(["--benchmark", "dgemm", "--strategy", "bandit",
                       "--budget", "6", "--seed", "0"], session="bandit",
                      cache_dir=search_dir)
    bandit_best = best_line(out)
    bandit_trials = progress_lines(out)
    print(f"  bandit (card DGEMM space, 8 configs): best {bandit_best[0]} "
          f"at {bandit_best[1]:.1f} GFLOP/s over {len(bandit_trials)} trials")
    for label, (_, score) in (("surrogate", sur_best),
                              ("bandit", bandit_best)):
        if not (math.isfinite(score) and score > 0):
            fail(f"{label}: best score {score}")

    # 3. the DGEMM shape sweep and its oracle
    out, _ = run_module("repro_torch.sweep", [
        "--session", "sweep", "--cache-dir", str(WORK / "sweep"),
        "--benchmark", "dgemm", "--grid", SWEEP["grid"],
        "--budget-per-shape", str(SWEEP["budget"]), "--oracle-eval",
        SWEEP["holdout"], "--seed", "0"], "sweep")
    shapes = re.findall(r"^ +(\S+): best=(\{.*?\}) score=(\S+) trials=(\d+)",
                        out, re.M)
    if len(shapes) != SWEEP["tuned"]:
        fail(f"sweep: {len(shapes)} tuned shapes, want {SWEEP['tuned']}")
    for key, cfg, score, _ in shapes:
        if not (math.isfinite(float(score)) and float(score) > 0):
            fail(f"sweep: shape {key} best {cfg} score {score}")
    gap = re.search(r"^eval +: optimum=(\{.*?\}) score=(\S+); oracle config "
                    r"scored (\S+) \(gap (\S+)%\)$", out, re.M)
    spent = re.search(r"^eval +: campaign spent (\d+) trials vs (\d+) "
                      r"exhaustive", out, re.M)
    oracle = re.search(r"^(oracle +: .*)$", out, re.M)
    answer = re.search(r"^(eval +: \S+ -> .*)$", out, re.M)
    if not (gap and spent and oracle and answer) \
            or not math.isfinite(float(gap.group(4))):
        print(out[-4000:])
        fail("sweep: no oracle answer, finite gap or trial count")
    for ln in out.splitlines():
        if ln.startswith(("  ", "total", "oracle", "eval")):
            print("  " + ln.strip())

    # 4. the dashboard over phase 5's cache, item 1's ledger, a phase-10
    # trace; phase 5's report beside the ledger it now holds
    html_path = WORK / "dash.html"
    trace = WORK / "device_timing" / "dgemm_card_space.jsonl"
    md, _ = run_module("repro_torch.roofline_report", [
        str(WORK / "roofline"), "--html", str(html_path), "--history",
        str(ledger_path), "--trace", str(trace)], "dashboard")
    html = html_path.read_text(encoding="utf-8")
    fp_cell = f"<td>peak compute F_p (dgemm)</td><td>{roofline_fp:.4g}</td>"
    wanted = {"roofline F_p": fp_cell,
              "trend": f"Trend — gemm_tiled @ <code>{fingerprint}</code>",
              "verdicts": "verdict-regressed",
              "trial drill-down": "<h2>Trial drill-down</h2>"}
    missing = [k for k, needle in wanted.items() if needle not in html]
    if missing:
        fail(f"dashboard {html_path}: no {missing}")
    if not (WORK / "roofline" / "history.jsonl").exists():
        fail("phase 5's cache dir holds no run ledger")
    m = re.search(r"peak compute F_p \(dgemm\) \| (\S+) GFLOP/s", md)
    print(f"  dashboard {html_path.stat().st_size} bytes: roofline F_p "
          f"{roofline_fp:.4g} GFLOP/s (markdown beside history.jsonl: "
          f"{m and m.group(1)}), the gemm_tiled trend, the verdicts and "
          f"the trial drill-down")
    return {"launches": launches, "gate": {"flat": flat, "drop": drop},
            "winner": winner, "surrogate": {"best": sur_best,
                                            "found_at": found_at,
                                            "reached_winner_at": reached},
            "bandit": bandit_best, "sweep": {
                "gap_pct": float(gap.group(4)),
                "spent": int(spent.group(1)),
                "exhaustive": int(spent.group(2))}}


def op_checks() -> dict:
    """Each ``repro_torch::*`` op on the card: FlopCounterMode and
    count_ops see that one op with its formula's FLOPs, and the op's
    output equals the wrapper's launch bit for bit; then TRIAD's host
    microseconds a call (n = 1024) through the wrapper, the op, the launch
    function without the op, and the bare ctypes launch."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis import count_ops
    from repro_torch.kernels import build, registry
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import flops as fa_flops
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.matmul import flops as mm_flops
    from repro_torch.kernels.ssd import chunk_scan, needed_flops
    from repro_torch.kernels.triad import flops as triad_flops
    from repro_torch.kernels.triad import ops as triad_ops
    from repro_torch.kernels.triad import triad
    gen = torch.Generator(device="cuda").manual_seed(13)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    b, h, hkv, s, d = FLASH_MAIN
    q, k, v = (randn(b, n, s, d, dtype=torch.bfloat16)
               for n in (h, hkv, hkv))
    x, y = randn(1 << 20), randn(1 << 20)
    ga, gb = randn(1024, 768), randn(768, 512)
    ssd = ssd_inputs(gen, 1, 8, 16, 256, 64, 128)[:4]
    B_, H_, C_, Q_, P_, N_ = ssd[0].shape + (ssd[1].shape[-1],)
    cases = {
        "triad": (lambda: triad(x, y, gamma=3.0),
                  lambda: registry.OPS["triad"](x, y, 3.0),
                  triad_flops(x.numel())),
        "matmul": (lambda: matmul(ga, gb, bm=128, bn=128, bk=16),
                   lambda: registry.OPS["matmul"](ga, gb, 128, 128, 16),
                   mm_flops(1024, 512, 768)),
        "flash_attention_fwd": (
            lambda: flash_attention(q, k, v, causal=True, bq=128, bk=128),
            lambda: registry.OPS["flash_attention_fwd"](
                q, k, v, 1.0 / math.sqrt(d), True, None, 128, 128),
            fa_flops(b, h, s, d, True)),
        "ssd_chunk_scan_fwd": (
            lambda: chunk_scan(*ssd),
            lambda: registry.OPS["ssd_chunk_scan_fwd"](*ssd, None,
                                                       False)[0],
            needed_flops(B_, H_, C_ * Q_, Q_, P_, N_)),
    }
    out = {}
    for name, (wrapper, op, formula) in cases.items():
        with FlopCounterMode(display=False) as counter:
            wrapper()
        counted = {str(key): n for key, n in
                   counter.get_flop_counts()["Global"].items()}
        module = count_ops(wrapper)
        kinds = [o.kind for o in module.ops]
        if counted != {f"repro_torch.{name}": int(formula)}:
            fail(f"op {name}: FlopCounterMode counted {counted}, want "
                 f"{{repro_torch.{name}: {int(formula)}}}")
        if kinds != [f"repro_torch::{name}"] or module.flops != formula:
            fail(f"op {name}: count_ops saw {kinds} with "
                 f"{module.flops:.6g} FLOPs, want the op alone with "
                 f"{formula:.6g}")
        got, want = op(), wrapper()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"op {name}: the op's output differs from the wrapper's "
                 f"launch on the same inputs")
        out[name] = {"flops": formula, "bytes": module.bytes_accessed}
        print(f"op repro_torch::{name}: FlopCounterMode and count_ops see "
              f"it alone, {formula:.6g} FLOPs (its formula), "
              f"{module.bytes_accessed:.6g} bytes; bit-identical to the "
              f"wrapper's launch")
    del q, k, v, x, y, ga, gb, ssd
    xs, ys = randn(1024), randn(1024)
    c = torch.empty_like(xs)
    launcher = build.kernel_fn("rt_triad_f32", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
    ptrs = (xs.data_ptr(), ys.data_ptr(), c.data_ptr(), xs.numel(), 3.0, 0,
            build.current_stream_ptr(0))
    host = {
        "triad wrapper (through the op)": host_us_per_call(
            lambda: triad(xs, ys, gamma=3.0)),
        "the op alone": host_us_per_call(
            lambda: registry.OPS["triad"](xs, ys, 3.0)),
        "launch function without the op": host_us_per_call(
            lambda: triad_ops._launch(xs, ys, 3.0)),
        "ctypes launch alone": host_us_per_call(lambda: launcher(*ptrs)),
    }
    print("TRIAD dispatch at n=1024 through the op (host us/call, back to "
          "back): " + " | ".join(f"{name} {us:.2f}"
                                 for name, us in host.items()))
    return {"ops": out, "host_us": host}


def print_attribution(label: str, report, path: pathlib.Path) -> dict:
    """Top ops, time by op kind, subsystem shares and the unattributed
    share of one report; writes its JSON to ``path``."""
    path.write_text(json.dumps(report.to_json(), indent=2),
                    encoding="utf-8")
    total = report.device_total_s or 0.0
    print(f"{label}: {len(report.ops)} ops, device total "
          f"{total * 1e3:.3f} ms, attributed {report.attributed_s * 1e3:.3f}"
          f" ms, unattributed_frac {report.unattributed_frac:.4f}; "
          f"{report.total_flops:.6g} FLOPs, {report.total_bytes:.6g} bytes "
          f"-> {path}")
    print("  top ops (device ms, % of roof):")
    for op in report.top_ops(10):
        pct = "—" if op.pct_of_roof is None else f"{op.pct_of_roof:.1f}%"
        print(f"    {op.name:40s} {(op.time_s or 0.0) * 1e3:9.3f} ms  "
              f"{op.bound:8s} {pct}")
    kinds: dict = {}
    for op in report.ops:
        t, n = kinds.get(op.kind, (0.0, 0))
        kinds[op.kind] = (t + (op.time_s or 0.0), n + 1)
    print("  by op kind (device ms, ops, share of the device total):")
    for kind, (t, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"    {kind:40s} {t * 1e3:9.3f} ms  {n:5d}  "
              f"{t / total if total else 0.0:6.1%}")
    sized: dict = {}
    for op in report.ops:
        key = (op.kind, op.bytes_accessed)
        t, n = sized.get(key, (0.0, 0))
        sized[key] = (t + (op.time_s or 0.0), n + 1)
    print("  by op kind and bytes an op (device ms, ops, achieved TB/s):")
    for (kind, moved), (t, n) in sorted(sized.items(),
                                        key=lambda kv: -kv[1][0])[:12]:
        print(f"    {kind:32s} {moved / 1e9:8.3f} GB  {t * 1e3:9.3f} ms  "
              f"{n:5d}  {moved * n / t / 1e12 if t else 0.0:6.3f}")
    shares = {sub: secs / total if total else 0.0
              for sub, secs in sorted(report.subsystem_seconds.items())}
    print("  subsystem shares: " + ", ".join(
        f"{sub} {share:.1%}" for sub, share in shares.items())
        + f", unattributed {report.unattributed_frac:.1%}")
    return {"device_ms": total * 1e3,
            "unattributed_frac": report.unattributed_frac,
            "shares": shares,
            "top": [(op.name, (op.time_s or 0.0) * 1e3, op.pct_of_roof)
                    for op in report.top_ops(10)],
            "by_kind_ms": {kind: t * 1e3 for kind, (t, _) in kinds.items()}}


def observability_path(tile: tuple[int, int]) -> dict:
    """Phase 13: the four ops, the linter with pass 1 on the card, a
    strict ``--live`` TRIAD session and a strict mis-declared one, the
    measured attributions of OBSERVE on phase 5's roofs (``tile``: phase
    6's flash tile), and the report CLI's ``--attribute``."""
    import dataclasses
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get
    from repro_torch.core import EvaluationSettings, Tuner, grid
    from repro_torch.lint import WorkloadAuditError, WorkloadSpec
    from repro_torch.models.transformer import StepConfig
    from repro_torch.models.workloads import build_workload
    from repro_torch.obs.attribution import attribute, roofs_from_trials

    ops = op_checks()

    # -- the linter, pass 1 bound to the card
    out, _ = run_module("repro_torch.lint", ["--json"], "lint", codes=(0,))
    doc = json.loads(out)
    if doc["summary"]["error"] or doc["summary"]["warning"]:
        fail(f"repro_torch.lint: {doc['summary']}")
    print(f"  lint: {doc['summary']} ({len(doc['findings'])} findings)")

    # -- strict, live TRIAD and tile-search sessions; a strict
    # mis-declared benchmark
    tune_counts = {}
    for bench, extra in (("triad", []),
                         ("gemm_tiled", ["--strategy", "random", "--budget",
                                         "3", "--seed", "0"])):
        _, tune_counts[bench] = run_tune(
            ["--benchmark", bench, "--validate", "strict", "--live",
             "--fresh", *extra], session="observe",
            log=f"tune_observe_{bench}")
        # the log's text holds the status line's carriage returns as
        # line ends
        live = [ln for ln in (WORK / f"tune_observe_{bench}.log").read_text(
            encoding="utf-8").splitlines() if ln.startswith("[live] ")]
        if not live:
            fail(f"tune --benchmark {bench} --live printed no live line")
        print(f"  last live line: {live[-1].strip()}")
    calls = []

    def mis_declared(cfg):
        calls.append(cfg)
        return lambda: (lambda: 1.0)

    mis_declared.audit_spec = lambda cfg: WorkloadSpec(
        fn=torch.matmul, args=(torch.empty(64, 64, device="meta"),) * 2,
        work=64.0 ** 3, unit="flops", dtype="float32", name="mis")
    try:
        Tuner(grid(x=(0, 1)), EvaluationSettings(
            max_invocations=1, max_iterations=1)).tune(
                mis_declared, validate="strict")
        fail("a mis-declared benchmark under validate='strict' ran")
    except WorkloadAuditError as e:
        if calls:
            fail(f"the strict audit raised after {len(calls)} trial(s)")
        print(f"  strict audit of a mis-declared benchmark raised before "
              f"any trial: {e.findings[0].code}")

    # -- measured attribution at full width
    roofs = roofs_from_trials([str(WORK / "roofline")])
    if roofs is None:
        fail("phase 5's cache gave no roofs")
    print(f"roofs (phase 5): F_p {roofs.peak_flops / 1e12:.3f} TFLOP/s, "
          + ", ".join(f"{k} {v / 1e12:.3f} TB/s"
                      for k, v in sorted(roofs.bandwidths.items())))
    reports = {}
    launches = {}
    for label, spec in OBSERVE.items():
        cfg = dataclasses.replace(get(spec["arch"]),
                                  n_layers=spec["layers"])
        step = StepConfig(use_flash=True, flash_block_q=tile[0],
                          flash_block_k=tile[1], remat=False)
        w = build_workload(spec["workload"], cfg, step=step,
                           batch_size=spec["batch"], seq_len=spec["seq"],
                           device="cuda")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        report = attribute(w, roofs, log_dir=str(WORK / f"attr_{label}"))
        wall = time.perf_counter() - t0
        launches[label] = kernels.launch_counts()
        print(f"{spec['arch']} {spec['workload']} ({cfg.n_layers} layers, "
              f"B={spec['batch']}, S={spec['seq']}): attribution wall "
              f"{wall:.1f}s (warm-up + profiled call), launches "
              f"{launches[label]}")
        reports[label] = print_attribution(
            label, report, WORK / f"attribution_{label}.json")
        held = {name: sum(op.time_s or 0.0 for op in report.ops
                          if op.kind == f"repro_torch::{name}")
                for name in spec["ops"]}
        for name, secs in held.items():
            if report.mode != "measured" or secs <= 0:
                fail(f"{label}: repro_torch::{name} holds no device time "
                     f"({report.mode})")
        reports[label]["kernel_op_ms"] = {name: secs * 1e3
                                          for name, secs in held.items()}
        del w, report
        gc.collect()
        torch.cuda.empty_cache()

    # -- the report CLI's --attribute (the tiny step, on the card)
    html = WORK / "attribution.html"
    out, _ = run_module("repro_torch.roofline_report", [
        str(WORK / "roofline"), "--attribute", "train_step", "--out",
        str(WORK / "attribution.md"), "--html", str(html),
        "--attribution-json", str(WORK / "attribution_cli.json")],
        "roofline_report_attribute")
    cli = json.loads((WORK / "attribution_cli.json").read_text())
    if "Attribution —" not in html.read_text(encoding="utf-8") or \
            cli["mode"] != "measured":
        fail(f"roofline_report --attribute: mode {cli['mode']}, html "
             f"without the attribution section")
    print(f"  roofline_report --attribute train_step: {len(cli['ops'])} "
          f"ops, measured, unattributed_frac "
          f"{cli['unattributed_frac']:.4f}")
    return {"ops": ops, "reports": reports, "launches": launches,
            "tune_launches": tune_counts}


def flash_stack_checks(tiles) -> dict:
    """The bf16 flash kernel at the causal self-attention shape (B, H,
    Hkv, S, D) of each STACK_STEP train step: llama-vision's (D = 128, the
    first path to launch it), granite-moe's, and whisper's decoder at
    B = 8 over its 448 text tokens (padded to the tile inside the op).
    Each is checked against the plain version at each of ``tiles``
    within FLASH_MAIN_TOL, and every launch must take the tensor-core
    kernel. The D = 128 shape is also timed at each tile (CUDA events)
    beside the plain version, scaled_dot_product_attention and the
    bound. Returns {"errs": max abs err per model, "d128": its timing}."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    errs, d128 = {}, None
    for label, spec in STACK_STEP.items():
        cfg = get(spec["arch"])
        b, h, hkv, s, d = shape = (spec["batch"], cfg.n_heads,
                                   cfg.n_kv_heads, spec["seq"],
                                   cfg.head_dim_)
        gen = torch.Generator(device="cuda").manual_seed(7)
        q, k, v = [torch.randn((b, heads, s, d), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for heads in (h, hkv, hkv)]
        want = attention_ref(q, k, v, causal=True, window=cfg.window)
        before = dict(flash_attention.route_launches)
        ms, err = {}, 0.0
        for tile in tiles:
            err = max(err, check_close(
                f"flash {shape} bf16 causal ({cfg.name}) tile {tile}",
                launch_checked(flash_attention, lambda t=tile:
                               flash_attention(q, k, v, causal=True,
                                               window=cfg.window,
                                               bq=t[0], bk=t[1])),
                want, FLASH_MAIN_TOL["bf16"]))
            if d == 128:
                ms[tile] = cuda_ms(lambda t=tile: flash_attention(
                    q, k, v, causal=True, bq=t[0], bk=t[1]), iters=10)
        after = dict(flash_attention.route_launches)
        if any(after[r] != before[r] for r in after if r != "tensor_cores") \
                or after["tensor_cores"] == before["tensor_cores"]:
            fail(f"flash {shape} bf16 ({cfg.name}): launches per route "
                 f"went from {before} to {after}, want the tensor-core "
                 f"kernel only")
        errs[label] = err
        print(f"flash {shape} bf16 causal ({cfg.name}'s self attention): "
              f"{len(tiles)} tiles ok, max abs err {err:.3e} (tol "
              f"{FLASH_MAIN_TOL['bf16']})")
        del want
        if d == 128:
            d128 = flash_d128_times(q, k, v, ms, err)
        del q, k, v
        torch.cuda.empty_cache()
    if d128 is None:
        fail("flash: no STACK_STEP model has head dim 128")
    return {"errs": errs, "d128": d128}


def flash_d128_times(q, k, v, ms: dict, err: float) -> dict:
    """The D = 128 shape's tile times ``ms`` beside the plain version,
    scaled_dot_product_attention and the bound, printed and returned."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     bytes_moved)
    from repro_torch.kernels.flash_attention import flops as flash_flops
    shape = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3])
    b, h, _, s, d = shape
    tile = min(ms, key=ms.get)
    flops, moved = flash_flops(b, h, s, d, True), bytes_moved(q, k)
    out = {"shape": shape, "kernel": ms[tile], "tile": tile, "tile_ms": ms,
           "max_abs_err": err,
           "plain": cuda_ms(lambda: attention_ref(q, k, v, causal=True),
                            iters=3, warmup=1),
           "library": cuda_ms(lambda: torch.nn.functional
                              .scaled_dot_product_attention(
                                  q, k, v, is_causal=True, enable_gqa=True),
                              iters=20),
           "bound": max(flops / BF16_PEAK, moved / HBM_PEAK) * 1e3,
           "bound_by": ("operations" if flops / BF16_PEAK >= moved / HBM_PEAK
                        else "bytes")}
    print(f"flash {shape} bf16 causal (D = 128): " + " | ".join(
              f"tile {t} {m:.4f} ms" for t, m in ms.items())
          + f" | kernel {out['kernel']:.4f} ms (tile {tile}, "
          f"{flops / out['kernel'] / 1e9:.2f} TFLOP/s, "
          f"{out['bound'] / out['kernel']:.1%} of its bound) | bound "
          f"{out['bound']:.4f} ms ({out['bound_by']}; FLOPs / 989 TFLOP/s, "
          f"bytes {moved / 1e6:.1f} MB / 3.35 TB/s) | plain "
          f"{out['plain']:.4f} ms | scaled_dot_product_attention "
          f"{out['library']:.4f} ms (kernel / library "
          f"{out['kernel'] / out['library']:.3f}) | max abs err {err:.3e}")
    return out


def flash_d256_times(randn, tiles) -> dict:
    """gemma-2b's attention widths (FLASH_D256): in f32 the 3xTF32 D = 256
    kernel at each of ``tiles`` (checked against the plain version first,
    within FLASH_MAIN_TOL), beside the CUDA-core kernel it replaced
    (checked too, on the same operands, and timed: ``was``), its plain
    version, scaled_dot_product_attention and its bounds at 165 and 67
    TFLOP/s; then in bf16 the tensor-core kernel at each tile (checked
    first) beside scaled_dot_product_attention and its bound at 989
    TFLOP/s. Every f32 launch must take the ``tf32x3_d256`` route. Returns
    {"f32": ..., "bf16": ...}, each with its times, tile and max abs
    err."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     bytes_moved,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention import flops as flash_flops
    gb, gh, ghkv, gs, gd = FLASH_D256
    d256 = [randn(gb, heads, gs, gd) for heads in (gh, ghkv, ghkv)]
    want = attention_ref(*d256, causal=True)
    before = flash_attention.route_launches["tf32x3_d256"]
    d256_ms = {}
    err = 0.0
    for tile in tiles:
        err = max(err, check_close(
            f"flash {FLASH_D256} f32 causal tile {tile}", flash_attention(
                *d256, causal=True, bq=tile[0], bk=tile[1]), want,
            FLASH_MAIN_TOL["f32"]))
        d256_ms[tile] = cuda_ms(lambda t=tile: flash_attention(
            *d256, causal=True, bq=t[0], bk=t[1]), iters=10, warmup=2)
    if flash_attention.route_launches["tf32x3_d256"] == before:
        fail(f"flash {FLASH_D256} f32 did not take the tf32x3_d256 kernel")
    d256_tile = min(d256_ms, key=d256_ms.get)
    was256 = cuda_core_flash(gd)
    err_was = check_close(
        f"flash {FLASH_D256} f32 CUDA-core kernel", was256(*d256, *d256_tile),
        want, FLASH_MAIN_TOL["f32"])
    del want
    d256_flops = flash_flops(gb, gh, gs, gd, True)
    d256_bytes = bytes_moved(d256[0], d256[1])
    flash256 = {
        "kernel": d256_ms[d256_tile], "tile": d256_tile, "tile_ms": d256_ms,
        "max_abs_err": err, "max_abs_err_was": err_was,
        "was": cuda_ms(lambda: was256(*d256, *d256_tile), iters=3,
                       warmup=1),
        "plain": cuda_ms(lambda: attention_ref(*d256, causal=True), iters=2,
                         warmup=1),
        "library": cuda_ms(lambda: torch.nn.functional
                           .scaled_dot_product_attention(
                               *d256, is_causal=True, enable_gqa=True),
                           iters=3, warmup=1),
        "bound": max(d256_flops / TF32X3_PEAK, d256_bytes / HBM_PEAK) * 1e3,
        "bound_by": ("operations" if d256_flops / TF32X3_PEAK
                     >= d256_bytes / HBM_PEAK else "bytes"),
        "bound_cuda_cores": max(d256_flops / F32_PEAK,
                                d256_bytes / HBM_PEAK) * 1e3}
    print(f"flash {FLASH_D256} f32 causal (3xTF32 on the tensor cores, Q "
          f"from registers): " + " | ".join(
              f"tile {t} {ms:.4f} ms" for t, ms in d256_ms.items())
          + f" | kernel {flash256['kernel']:.4f} ms (tile {d256_tile}, "
          f"{d256_flops / flash256['kernel'] / 1e9:.2f} TFLOP/s, "
          f"{flash256['bound'] / flash256['kernel']:.1%} of its bound) | was "
          f"{flash256['was']:.4f} ms (CUDA-core kernel, same run; "
          f"{flash256['was'] / flash256['kernel']:.2f}x) | "
          f"bound {flash256['bound']:.4f} ms (FLOPs / 165 TFLOP/s, 3xTF32; "
          f"{flash256['bound_by']}), {flash256['bound_cuda_cores']:.4f} ms "
          f"(FLOPs / 67 TFLOP/s, CUDA cores) | plain "
          f"{flash256['plain']:.4f} ms | scaled_dot_product_attention "
          f"{flash256['library']:.4f} ms (kernel / library "
          f"{flash256['kernel'] / flash256['library']:.3f}) | max abs err "
          f"{err:.3e} (CUDA-core kernel {err_was:.3e})")
    d256 = [x.bfloat16() for x in d256]
    want = attention_ref(*d256, causal=True)
    bf16_256_ms, err_bf16 = {}, 0.0
    for tile in tiles:
        err_bf16 = max(err_bf16, check_close(
            f"flash {FLASH_D256} bf16 causal tile {tile}", flash_attention(
                *d256, causal=True, bq=tile[0], bk=tile[1]), want,
            FLASH_MAIN_TOL["bf16"]))
        bf16_256_ms[tile] = cuda_ms(lambda t=tile: flash_attention(
            *d256, causal=True, bq=t[0], bk=t[1]), iters=10)
    del want
    bf16_256_bytes = bytes_moved(d256[0], d256[1])
    bf16_256 = {
        "tile_ms": bf16_256_ms, "max_abs_err": err_bf16,
        "tile": min(bf16_256_ms, key=bf16_256_ms.get),
        "library": cuda_ms(lambda: torch.nn.functional
                           .scaled_dot_product_attention(
                               *d256, is_causal=True, enable_gqa=True),
                           iters=10),
        "bound": max(d256_flops / BF16_PEAK,
                     bf16_256_bytes / HBM_PEAK) * 1e3,
        "bound_by": ("operations" if d256_flops / BF16_PEAK
                     >= bf16_256_bytes / HBM_PEAK else "bytes")}
    bf16_256["kernel"] = bf16_256_ms[bf16_256["tile"]]
    print(f"flash {FLASH_D256} bf16 causal (tensor cores): " + " | ".join(
        f"tile {t} {ms:.4f} ms" for t, ms in bf16_256_ms.items())
        + f" | bound {bf16_256['bound']:.4f} ms (FLOPs / 989 TFLOP/s; "
        f"{bf16_256['bound_by']}) | scaled_dot_product_attention "
        f"{bf16_256['library']:.4f} ms (kernel / library "
        f"{bf16_256['kernel'] / bf16_256['library']:.3f})")
    del d256
    torch.cuda.empty_cache()
    return {"f32": flash256, "bf16": bf16_256}


def stack_train_step(spec: dict, tile: tuple[int, int]) -> dict:
    """One model's train step at full width (STACK_STEP) on the plain path
    and on the flash path at ``tile``: each a warm-up step, then the
    timed ones with the launch counts set to 0 just before them and read
    just after: STACK_STEP_REPEATS timed steps, the faster one reported.
    Requires finite losses and gradients, one flash launch a step per
    causal self-attention layer on the flash path (all on the tensor-core
    kernel) and none on the plain path, and the two losses within
    MODEL_STEP["loss_rtol"]."""
    import dataclasses
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get
    from repro_torch.models.transformer import StepConfig
    from repro_torch.models.workloads import build_workload
    full = get(spec["arch"])
    cfg = dataclasses.replace(full, n_layers=spec.get("layers",
                                                      full.n_layers))
    b, s = spec["batch"], spec["seq"]
    w = build_workload("train_step", cfg, batch_size=b, seq_len=s)
    want_flash = kv_layers(cfg)
    runs = {}
    for label, step in (("plain", StepConfig(remat=False)),
                        ("flash", StepConfig(use_flash=True,
                                             flash_block_q=tile[0],
                                             flash_block_k=tile[1],
                                             remat=False))):
        fn = w.with_step(step).fn
        gc.collect()
        torch.cuda.empty_cache()
        fn(*w.args)                                  # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        routes = dict(kernels.flash_attention.route_launches)
        ms, grads = [], None
        for _ in range(STACK_STEP_REPEATS):
            grads = None                  # one step's gradients at a time
            t0 = time.perf_counter()
            loss, grads = fn(*w.args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = kernels.launch_counts()
        routes = {r: n - routes[r] for r, n in
                  kernels.flash_attention.route_launches.items()}
        peak = torch.cuda.max_memory_allocated()
        if not math.isfinite(float(loss)) or not all(
                bool(torch.isfinite(g).all()) for g in tree_leaves(grads)):
            fail(f"{cfg.name} train step ({label}): non-finite loss "
                 f"{float(loss)} or gradients")
        del grads
        want = STACK_STEP_REPEATS * want_flash if step.use_flash else 0
        if launches["flash_attention"] != want or \
                routes["tensor_cores"] != want:
            fail(f"{cfg.name} train step ({label}): launches {launches}, "
                 f"routes {routes}; want {want} flash launches on the "
                 f"tensor-core kernel")
        runs[label] = {"loss": float(loss), "ms": min(ms), "ms_each": ms,
                       "peak_gib": peak / 2 ** 30, "launches": launches}
    rel = abs(runs["flash"]["loss"] / runs["plain"]["loss"] - 1.0)
    depth = (f"depth cut from {full.n_layers} to {cfg.n_layers} layers"
             if cfg.n_layers != full.n_layers else
             f"all {cfg.n_layers} layers")
    extra = "".join(f", {k} {tuple(v.shape)}" for k, v in w.args[1].items()
                    if k != "tokens")
    experts = (f" x {cfg.n_experts} experts, top-{cfg.top_k}"
               if cfg.n_experts else "")
    print(f"{cfg.name} train step at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_kv_heads} kv heads of "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}{experts}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}); {depth} "
          f"({cfg.n_params() / 1e9:.3f}B params); B={b}, S={s}{extra}")
    for label, r in runs.items():
        print(f"  use_flash={int(label == 'flash')}"
              + (f" tile {tile}" if label == "flash" else "")
              + f": loss {r['loss']:.6f}, step {r['ms']:.1f} ms (the "
              f"faster of " + ", ".join(f"{t:.1f}" for t in r["ms_each"])
              + f"), peak "
              f"memory {r['peak_gib']:.2f} GiB, launches {r['launches']}")
    print(f"  loss use_flash=1 vs 0: relative {rel:.3e} (tol "
          f"{MODEL_STEP['loss_rtol']}); {want_flash} flash launches a step "
          f"(one per causal self-attention layer), "
          f"{STACK_STEP_REPEATS} timed steps each")
    if not (math.isfinite(rel) and rel <= MODEL_STEP["loss_rtol"]):
        fail(f"{cfg.name} train step: flash loss {runs['flash']['loss']} "
             f"vs plain {runs['plain']['loss']}")
    del w
    gc.collect()
    torch.cuda.empty_cache()
    return {**runs, "loss_rel": rel, "flash_launches": want_flash}


def model_stack_path(tile: tuple[int, int], tiles) -> dict:
    """Phase 14: the MoE, VLM and enc-dec families at full width. The
    bf16 flash kernel at each train step's shape
    (:func:`flash_stack_checks`, llama-vision's D = 128 timed);
    the train steps of STACK_STEP (:func:`stack_train_step`); the serves
    of STACK_SERVE (:func:`served`), each one's decode also eager against
    captured (:func:`replayed_decode`); and decode continuing prefill in
    f32 at STACK_CONTINUE's depths (:func:`serving_continues_prefill`)."""
    import torch
    out = {"flash": flash_stack_checks(tiles), "train": {}, "serve": {}}
    for label, spec in STACK_STEP.items():
        out["train"][label] = stack_train_step(spec, tile)
    for label, spec in STACK_SERVE.items():
        run = served(spec)
        run.update(replayed_decode(run["state"]))
        del run["state"]
        torch.cuda.empty_cache()
        out["serve"][label] = run
    out["continue"] = {arch: serving_continues_prefill(arch, layers)
                       for arch, layers in STACK_CONTINUE.items()}
    return out


class UpdateTimer:
    """Stands in for ``repro_torch.train.steps.adamw_update`` during a
    training run: each eager call between two CUDA events, its metrics
    (0-d tensors on the card) kept to be read after the run; a call
    inside a CUDA graph's capture passes straight through."""

    def __init__(self, fn):
        self.fn = fn
        self.events: list = []
        self.metrics: list = []

    def __call__(self, *args, **kwargs):
        import torch
        if torch.cuda.is_current_stream_capturing():
            # inside a CUDA graph's capture: replays run the update with
            # no call here, so a captured step's update is not timed
            return self.fn(*args, **kwargs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kwargs)
        end.record()
        self.events.append((start, end))
        self.metrics.append(out[2])
        return out

    def ms(self) -> list[float]:
        """Milliseconds of each update (after a synchronize)."""
        return [s.elapsed_time(e) for s, e in self.events]


def timed_training(run, label: str) -> dict:
    """``run()`` (a training run on the card) with the AdamW update timed
    (:class:`UpdateTimer`), the launch counts set to 0 just before it and
    read just after, and the peak memory: the run's result, the update's
    ms and global norm per step, the launches by kernel and by flash
    route, the peak GiB and the wall seconds. Fails on a non-finite loss
    or norm."""
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.train import steps as steps_mod
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = UpdateTimer(steps_mod.adamw_update)
    steps_mod.adamw_update = timer
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = run()
    finally:
        steps_mod.adamw_update = timer.fn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    routes = dict(kernels.flash_attention.route_launches)
    norms = [float(m["grad_norm"]) for m in timer.metrics]
    losses = result["losses"]
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"{label}: non-finite loss {losses} or global norm {norms}")
    return {"result": result, "update_ms": timer.ms(), "grad_norm": norms,
            "lr": [float(m["lr"]) for m in timer.metrics],
            "launches": launches, "routes": routes,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "wall_s": wall}


def launcher_training() -> dict:
    """Phase 15 (a): mamba2-130m at its published config through
    ``repro_torch.launch.train.train`` (TRAIN_LAUNCH): an eager run
    (``graphs.disabled()``), the straight run (its steps replayed from a
    CUDA graph from the third on), the first part with a checkpoint and
    a resumed run to the same step (a graph of its own), and an eager run
    again. The loss must fall by more than TRAIN_LAUNCH["loss_drop"], the
    resumed run's last loss must equal the straight run's within
    TRAIN_LAUNCH["resume_rtol"], the straight run's first losses must
    equal the eager run's within the spread of the two eager runs
    (bitwise where they are), and every run must launch the SSD kernel
    twice a layer a step and no flash kernel."""
    import contextlib
    import statistics
    from repro_torch import graphs
    from repro_torch.configs import get
    from repro_torch.launch.train import train
    spec = TRAIN_LAUNCH
    cfg = get(spec["arch"])
    ckpt = WORK / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    eager = spec["eager_steps"]
    plan = (("eager", eager, None, True),
            ("straight", spec["steps"], None, False),
            ("first part", spec["split"], ckpt, False),
            ("resumed", spec["steps"], ckpt, False),
            ("eager again", eager, None, True))
    runs = {}
    for label, steps, ckpt_dir, is_eager in plan:
        print(f"-- {label}: launch.train.train({spec['arch']!r}, "
              f"steps={steps}, batch={spec['batch']}, seq={spec['seq']}, "
              f"smoke=False, ckpt_dir={ckpt_dir and ckpt_dir.name}, "
              f"device='cuda')" + (" under graphs.disabled()"
                                   if is_eager else ""), flush=True)
        with graphs.disabled() if is_eager else contextlib.nullcontext():
            run = timed_training(lambda: train(
                spec["arch"], steps=steps, batch=spec["batch"],
                seq=spec["seq"], smoke=False,
                ckpt_dir=str(ckpt_dir) if ckpt_dir else None,
                log_every=10, device="cuda"), f"{cfg.name} {label}")
        n = len(run["result"]["losses"])
        ssd = run["launches"]["ssd_chunk_scan"]
        if ssd == 0 or run["launches"]["flash_attention"] != 0:
            fail(f"{cfg.name} {label}: launches {run['launches']}; want "
                 f"SSD launches and no flash launch")
        if not run["result"]["dtensor"]:
            fail(f"{cfg.name} {label}: the launcher's parameters are not "
                 f"DTensors on the host mesh")
        if ssd != 2 * cfg.n_layers * n:
            fail(f"{cfg.name} {label}: {ssd} SSD launches over {n} steps, "
                 f"want {2 * cfg.n_layers} a step (forward and remat "
                 f"recompute)")
        update = run["update_ms"][1:]
        run.update(steps=n, ssd_per_step=ssd / n, eager=is_eager,
                   step_ms=run["result"]["mean_step_s"] * 1e3,
                   update_ms_mean=statistics.mean(update) if update
                   else None)
        runs[label] = run
    size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    kept = sorted(p.name for p in ckpt.iterdir())
    shutil.rmtree(ckpt, ignore_errors=True)
    straight, resumed = runs["straight"], runs["resumed"]
    first, last = straight["result"]["losses"][0], \
        straight["result"]["losses"][-1]
    rel = abs(resumed["result"]["losses"][-1] / last - 1.0)
    e1, e2 = (runs[k]["result"]["losses"] for k in ("eager", "eager again"))
    spread = max(abs(a - b) for a, b in zip(e1, e2))
    gap = max(abs(a - b) for a, b in zip(e1, straight["result"]["losses"]))
    print(f"{cfg.name} trained through the launcher at its published config "
          f"(d_model {cfg.d_model}, {cfg.ssm_heads} SSD heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
          f"{cfg.ssm_chunk}, vocab {cfg.vocab_size}, {cfg.dtype}); all "
          f"{cfg.n_layers} layers ({cfg.n_params() / 1e6:.1f}M params); "
          f"B={spec['batch']}, S={spec['seq']}; remat, AdamW, cosine "
          f"schedule (peak 3e-3, warmup 100); no cut")
    for label, run in runs.items():
        losses = run["result"]["losses"]
        update = ("AdamW update "
                  f"{run['update_ms_mean']:.3f} ms (CUDA events, mean after "
                  f"the first)" if run["update_ms_mean"] is not None else
                  "AdamW update inside the graph (not timed)")
        print(f"  {label} ({'eager' if run['eager'] else 'captured'}): "
              f"{run['steps']} steps, step {run['step_ms']:.2f} ms (mean "
              f"after the first{'' if run['eager'] else ' two'}), {update}, "
              f"loss {losses[0]:.6f} -> {losses[-1]:.6f}, peak memory "
              f"{run['peak_gib']:.2f} GiB, SSD launches "
              f"{run['launches']['ssd_chunk_scan']} "
              f"({run['ssd_per_step']:g} a step: {cfg.n_layers} + "
              f"{cfg.n_layers} recomputed), flash 0, wall "
              f"{run['wall_s']:.1f} s; DTensors on the host mesh "
              f"{run['result']['mesh']}")
    print(f"  checkpoints kept {kept}, {size / 2 ** 30:.3f} GiB on disk")
    print(f"  loss drop over {spec['steps']} steps {first - last:.6f} "
          f"(must exceed {spec['loss_drop']}); resumed last loss "
          f"{resumed['result']['losses'][-1]:.6f} vs straight {last:.6f}: "
          f"relative {rel:.3e} (tol {spec['resume_rtol']}); the first "
          f"{eager} losses captured vs eager: max abs difference {gap:.3e} "
          f"(eager vs eager again {spread:.3e})")
    print(f"  step ms: eager {runs['eager']['step_ms']:.2f}, captured "
          f"{straight['step_ms']:.2f}, eager again "
          f"{runs['eager again']['step_ms']:.2f}")
    if not first - last > spec["loss_drop"]:
        fail(f"{cfg.name}: the loss fell {first - last} over "
             f"{spec['steps']} steps")
    if len(resumed["result"]["losses"]) != spec["steps"] - spec["split"]:
        fail(f"{cfg.name}: the resumed run took "
             f"{len(resumed['result']['losses'])} steps, not from step "
             f"{spec['split']}")
    if not rel <= spec["resume_rtol"]:
        fail(f"{cfg.name}: resumed last loss "
             f"{resumed['result']['losses'][-1]} vs straight {last}")
    if not gap <= spread:
        fail(f"{cfg.name}: captured losses {straight['result']['losses']} "
             f"differ from the eager ones {e1} by {gap}, more than the "
             f"eager runs' spread {spread}")
    return {"runs": runs, "loss_drop": first - last, "resume_rel": rel,
            "ckpt_gib": size / 2 ** 30, "eager_gap": gap,
            "eager_spread": spread,
            "ssd_launches": sum(r["launches"]["ssd_chunk_scan"]
                                for r in runs.values())}


def dense_training(tile: tuple[int, int]) -> dict:
    """Phase 15 (b): granite-3-2b at all its layers (TRAIN_DENSE) through
    ``train.steps.build_train_step`` with the bf16 flash kernel at
    ``tile``, remat and AdamW, on the synthetic stream: one training run
    whose steps go in turns eagerly (``bundle.fn``) and through
    ``bundle.jitted()`` (its first call eager, the second captured, the
    rest replayed), as TRAIN_DENSE["modes"] lists them, each timed
    between two synchronizes. Reports the mean of the eager steps after
    the first and of the replayed ones, and each mode's peak memory (the
    captured one's over its warm-up and capture). Every flash launch must
    take the tensor-core route, 2 a layer a step."""
    import gc
    import statistics
    import torch
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import api
    from repro_torch.models.config import WorkloadShape
    from repro_torch.models.params import materialize, n_params
    from repro_torch.models.transformer import StepConfig
    from repro_torch.optim import adamw_init
    from repro_torch.train.steps import build_train_step
    spec = TRAIN_DENSE
    modes = spec["modes"]
    cfg = get(spec["arch"])
    b, s = spec["batch"], spec["seq"]
    step_cfg = StepConfig(use_flash=True, flash_block_q=tile[0],
                          flash_block_k=tile[1], remat=True)
    bundle = build_train_step(cfg, WorkloadShape("train_4k_b1", s, b,
                                                 "train"), step_cfg=step_cfg)
    jitted = bundle.jitted()
    defs = api.param_defs(cfg)
    params = materialize(torch.Generator(device="cuda").manual_seed(0), defs)
    opt = adamw_init(defs, "cuda")
    pipeline = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size), b, s,
                           device="cuda")
    step_ms: list[float] = []
    peaks: dict = {}

    def run() -> dict:
        nonlocal params, opt
        losses = []
        for i, mode in enumerate(modes):
            batch = pipeline.batch_at(i)
            torch.cuda.synchronize()
            if i == 0 or mode != modes[i - 1]:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fn = bundle.fn if mode == "eager" else jitted
            params, opt, metrics = fn(params, opt, batch, i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            peaks[mode] = max(peaks.get(mode, 0.0),
                              torch.cuda.max_memory_allocated() / 2 ** 30)
            losses.append(float(metrics["loss"]))
        return {"losses": losses}

    out = timed_training(run, f"{cfg.name} train")
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    jitted.release()
    n = len(modes)
    flash = out["launches"]["flash_attention"]
    if flash != 2 * cfg.n_layers * n or out["routes"]["tensor_cores"] != \
            flash:
        fail(f"{cfg.name} train: flash launches {flash}, routes "
             f"{out['routes']}; want {2 * cfg.n_layers} a step, all on the "
             f"tensor cores")
    count = n_params(defs)
    losses = out["result"]["losses"]
    first_captured = modes.index("captured")
    eager_ms = [t for i, t in enumerate(step_ms)
                if modes[i] == "eager" and i > 0]
    replayed_ms = [t for i, t in enumerate(step_ms)
                   if modes[i] == "captured" and i > first_captured + 1]
    out.update(step_ms=statistics.mean(eager_ms), step_ms_each=step_ms,
               captured_step_ms=statistics.mean(replayed_ms),
               eager_peak_gib=peaks["eager"],
               captured_peak_gib=peaks["captured"], reserved_gib=reserved,
               update_ms_mean=statistics.mean(out["update_ms"][1:]),
               flash_per_step=flash / n)
    print(f"{cfg.name} trained through build_train_step at its published "
          f"config (d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.n_kv_heads} kv heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}); all {cfg.n_layers} layers "
          f"({count / 1e9:.3f}B params: {count * 2 / 1e9:.2f} GB of weights,"
          f" {count * 8 / 1e9:.2f} GB of f32 moments); B={b}, S={s} (batch "
          f"256 -> 1); use_flash=1 tile {tile}, remat, AdamW, lr from the "
          f"cosine schedule (steps 0-{n - 1}: warmup)")
    print(f"  {n} steps ({', '.join(modes)}): eager step "
          f"{out['step_ms']:.1f} ms (mean after the first), replayed step "
          f"{out['captured_step_ms']:.1f} ms (mean after the warm-up and the "
          f"capture); each " + ", ".join(f"{t:.1f}" for t in step_ms)
          + f"; AdamW update {out['update_ms_mean']:.2f} ms (CUDA events, "
          f"eager steps; each " + ", ".join(f"{t:.2f}" for t in
                                            out["update_ms"])
          + f"), global norm {out['grad_norm'][-1]:.4f}, loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}; peak memory eager "
          f"{out['eager_peak_gib']:.2f} GiB, captured "
          f"{out['captured_peak_gib']:.2f} GiB (warm-up, capture, replays), "
          f"reserved {reserved:.2f} GiB with the graph held; launches "
          f"{out['launches']} (flash {out['flash_per_step']:g} a step, "
          f"routes {out['routes']})")
    del params, opt, bundle, jitted
    gc.collect()
    torch.cuda.empty_cache()
    return out


def adamw_card_check() -> dict:
    """Phase 15: ``adamw_update`` on the card against the same steps on
    the host, on the same parameters and gradients (ADAMW_CHECK). Returns
    the max abs error of every leaf and moment, the share of each bf16
    leaf's elements that differ (by one ulp at most) and both norms."""
    import torch
    from repro_torch.configs import get
    from repro_torch.models.params import flatten, map_tree, unflatten
    from repro_torch.optim import adamw_update
    cfg = get(TRAIN_DENSE["arch"])
    d = cfg.d_model
    specs = {"layers/mlp/w_up": ((d, cfg.d_ff), torch.bfloat16),
             "layers/mlp/w_up_f32": ((d, cfg.d_ff), torch.float32),
             "layers/ln1": ((d,), torch.bfloat16),
             "embed": ((cfg.vocab_size, d), torch.bfloat16)}
    gen = torch.Generator(device="cuda").manual_seed(11)

    def draw(scale: float) -> dict:
        return unflatten({k: (torch.randn(shape, generator=gen,
                                          device="cuda") * scale).to(dtype)
                          for k, (shape, dtype) in specs.items()})

    def zeros() -> dict:
        return unflatten({k: torch.zeros(shape, device="cuda")
                          for k, (shape, _) in specs.items()})

    def to_host(tree: dict) -> dict:
        return map_tree(lambda _, x: x.cpu(), tree)

    t0 = time.perf_counter()
    params = draw(d ** -0.5)
    opt = {"m": zeros(), "v": zeros(),
           "count": torch.zeros((), device="cuda")}
    host_params, host_opt = to_host(params), to_host(opt)
    norms, errs, flips = [], {}, {}
    for lr in ADAMW_CHECK["lrs"]:
        grads = draw(1.0)
        _, _, got = adamw_update(params, grads, opt, lr)
        _, _, want = adamw_update(host_params, to_host(grads), host_opt, lr)
        norms.append((float(got["grad_norm"]), float(want["grad_norm"])))
        if not abs(norms[-1][0] / norms[-1][1] - 1.0) <= 1e-6:
            fail(f"adamw on the card: global norm {norms[-1][0]} vs the "
                 f"host's {norms[-1][1]}")
        got_all = flatten({"params": params, **opt})
        for path, host in flatten({"params": host_params,
                                   **host_opt}).items():
            out, want = got_all[path], host.to("cuda")
            tol = {"rtol": 1e-6, "atol": 1e-6 * float(want.abs().max())}
            if out.dtype == torch.bfloat16:
                share = float((out != want).float().mean())
                flips[path] = max(flips.get(path, 0.0), share)
                if share > ADAMW_CHECK["flip_share"]:
                    fail(f"adamw on the card: {path} differs from the "
                         f"host's in {share:.3e} of its elements")
                tol["rtol"] = 2.0 ** -7
            err = check_close(f"adamw on the card {path} at lr {lr}", out,
                              want, tol)
            errs[path] = max(errs.get(path, 0.0), err)
            out.copy_(want)       # the next step starts from the host's
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"adamw_update on the card vs the host ({cfg.name}'s widest leaf "
          f"({d}, {cfg.d_ff}) in bf16 and f32, embedding ({cfg.vocab_size},"
          f" {d}) and a norm in bf16; {len(norms)} steps at lr "
          f"{ADAMW_CHECK['lrs']}, clip active: global norms "
          + ", ".join(f"{a:.4f}/{b:.4f}" for a, b in norms) + "): max abs "
          "err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + "; share of bf16 elements that differ (most in a step) "
          + ", ".join(f"{k} {v:.3e}" for k, v in flips.items())
          + f" ({seconds:.1f} s)")
    return {"max_abs_err": errs, "bf16_flip_share": flips,
            "grad_norms": norms}


def training_launch_path(tile: tuple[int, int]) -> dict:
    """Phase 15: the training launch, :func:`adamw_card_check`, then (a)
    :func:`launcher_training` and (b) :func:`dense_training`."""
    return {"adamw_check": adamw_card_check(),
            "launcher": launcher_training(), "dense": dense_training(tile)}


def start_dry_runs() -> dict:
    """Phase 16 (a, b): the dry-run cells and the perf driver, each in a
    process of its own with ``CUDA_VISIBLE_DEVICES=""`` (a fake world of
    256 or 512 ranks, nothing on the card), started together; collected
    by :func:`dry_run_checks`."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    procs = {}
    (WORK / "dryrun").mkdir(parents=True, exist_ok=True)
    for label, args in DRY_RUN.items():
        out = WORK / "dryrun" / f"{label}.jsonl"
        out.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
               "--out", str(out)]
        procs[label] = (cmd, out)
    procs["perf"] = ([sys.executable, "-m", "repro_torch.launch.perf",
                      *PERF_VARIANT], None)
    running = {}
    for label, (cmd, out) in procs.items():
        print("$ CUDA_VISIBLE_DEVICES= " + " ".join(cmd[1:]), flush=True)
        log = open(WORK / "dryrun" / f"{label}.log", "w", encoding="utf-8")
        running[label] = (subprocess.Popen(cmd, cwd=REPO, env=env,
                                           stdout=log,
                                           stderr=subprocess.STDOUT),
                          out, log, time.perf_counter())
    return running


def local_args_bytes(cfg, shape, sizes: dict) -> float:
    """Bytes of rank 0's local shards of a train step's arguments
    (params, opt state, batch, step) on a mesh of ``sizes``: each leaf's
    numel over the product of the mesh axes its spec gives it (the rules
    only take axes that divide)."""
    import math
    import types
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import api
    from repro_torch.models.config import input_specs
    from repro_torch.optim import opt_state_defs
    mesh = types.SimpleNamespace(shape=sizes)
    defs = api.param_defs(cfg)
    leaves = []

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            else:
                leaves.append((v.logical, v.shape, v.dtype))

    walk(defs)
    walk(opt_state_defs(defs))
    for s in input_specs(cfg, shape).values():
        leaves.append((("batch",) + (None,) * (len(s.shape) - 1),
                       tuple(s.shape), s.dtype))
    total = 4.0                                       # the int32 step
    for logical, dims, dtype in leaves:
        spec = sh.logical_to_spec(logical, dims, sh.TRAIN_RULES, mesh)
        n = math.prod(dims)
        for entry in spec:
            for ax in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= sizes[ax]
        total += n * dtype.itemsize
    return total


def dry_run_checks(running: dict) -> dict:
    """Phase 16 (a, b): wait for :func:`start_dry_runs`' processes and
    check them: granite-3-2b train_4k on the (16, 16) world with its
    three terms finite and positive, its model FLOPs 6·N_active·tokens,
    its argument bytes the sum of rank 0's local shards, and the full
    depth's FLOPs equal to the 1-/2-unit extrapolation (1e-6 relative);
    zamba2-2.7b decode_32k on the (2, 16, 16) world ok; the perf driver's
    baseline, variant and delta."""
    import math
    from repro_torch.configs import get
    from repro_torch.models.config import SHAPES
    out = {}
    for label, (proc, path, log, t0) in running.items():
        rc = proc.wait(timeout=SUBPROCESS_TIMEOUT_S)
        log.close()
        seconds = time.perf_counter() - t0
        text = (WORK / "dryrun" / f"{label}.log").read_text(encoding="utf-8")
        if rc != 0:
            print(text[-4000:])
            fail(f"dry run {label}: exit {rc}")
        out[label] = {"seconds": seconds, "log": text}
        if path is not None:
            out[label]["record"] = json.loads(
                path.read_text(encoding="utf-8").splitlines()[-1])
    rec = out["granite"]["record"]
    cfg, shape = get("granite_3_2b"), SHAPES["train_4k"]
    terms = [rec[k] for k in ("compute_ms", "memory_ms", "collective_ms")]
    if rec["status"] != "ok" or not all(math.isfinite(t) and t > 0
                                        for t in terms):
        fail(f"dry run granite: {rec}")
    want_flops = 6.0 * cfg.n_active_params() * shape.tokens
    if rec["model_flops_total"] != want_flops:
        fail(f"dry run granite: model FLOPs {rec['model_flops_total']} vs "
             f"6·N·D {want_flops}")
    args = local_args_bytes(cfg, shape, {"data": 16, "model": 16})
    if rec["args_bytes_per_dev"] != args:
        fail(f"dry run granite: argument bytes {rec['args_bytes_per_dev']} "
             f"vs rank 0's local shards {args}")
    if not rec["extrapolation_rel_err"] <= 1e-6:
        fail(f"dry run granite: full depth vs extrapolation "
             f"{rec['extrapolation_rel_err']:.3e}")
    zam = out["zamba2"]["record"]
    if zam["status"] != "ok" or zam["chips"] != 512:
        fail(f"dry run zamba2: {zam}")
    perf_log = out["perf"]["log"]
    for tag in ("[baseline] compute=", "[variant ] compute=",
                "[delta] lower bound"):
        if tag not in perf_log:
            fail(f"launch.perf printed no {tag!r}")
    print(f"dry run granite-3-2b train_4k on a fake (16, 16) world "
          f"({out['granite']['seconds']:.1f} s, trace {rec['compile_s']} s): "
          f"H100 estimates compute {rec['compute_ms']} ms, memory "
          f"{rec['memory_ms']} ms, collective {rec['collective_ms']} ms -> "
          f"{rec['dominant']}; peak {rec['peak_gb']} GB/dev, args "
          f"{rec['args_bytes_per_dev'] / 1e9:.4f} GB = rank 0's local shards;"
          f" model FLOPs {rec['model_flops_total']:.4e} = 6·N·D; "
          f"extrapolation rel. difference {rec['extrapolation_rel_err']:.1e}"
          f"; collectives {rec['collectives']}")
    print(f"dry run zamba2-2.7b decode_32k on a fake (2, 16, 16) world "
          f"({out['zamba2']['seconds']:.1f} s): {zam['status']}, peak "
          f"{zam['peak_gb']} GB/dev")
    print("launch.perf granite-3-2b train_4k --remat-policy dots_saveable "
          f"({out['perf']['seconds']:.1f} s):")
    for line in perf_log.splitlines():
        if line.startswith(("[baseline]", "[variant ]", "[delta]")):
            print("  " + line)
    return {"granite": rec, "zamba2": zam,
            "seconds": {k: v["seconds"] for k, v in out.items()}}


def sharded_steps(tile: tuple[int, int]) -> dict:
    """Phase 16 (c, d): granite-3-2b at full width (DIST_STEP) through
    ``build_train_step`` on ``make_host_mesh()`` with TRAIN_RULES, the
    bf16 flash kernel at ``tile`` and remat: DIST_STEP["steps"] steps
    through ``bundle.jitted()`` (the first eager, the second captured in
    a CUDA graph, the rest replayed) against the same captured steps with
    ``mesh=None`` from the same weights and batches (losses, global norms
    and final parameters bitwise), and those against the meshless steps
    run eagerly twice (``graphs.disabled()``: within the two eager runs'
    spread); the
    flash launches, all on the tensor cores; both step times and peak
    memory; the dry run's peak-bytes estimate of this step (traced on
    ``meta``) within PEAK_ESTIMATE of the measured peak; then one step
    under each of DIST_POLICIES from the same weights: loss, global norm
    and updated parameters equal to nothing_saveable's, its peak memory,
    and nothing_saveable's peak below everything_saveable's. Returns,
    beside these, every wrapper's launches and flash attention's launches
    per route, summed over the sharded runs (each counted from 0 just
    before its steps and read just after)."""
    import contextlib
    import dataclasses
    import gc
    import statistics
    import torch
    from repro_torch import graphs, kernels
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.models.config import WorkloadShape
    from repro_torch.models.params import flatten, materialize
    from repro_torch.models.transformer import StepConfig
    from repro_torch.optim import adamw_init
    from repro_torch.train.steps import build_train_step
    spec = DIST_STEP
    cfg = dataclasses.replace(get(spec["arch"]), n_layers=spec["layers"])
    b, s = spec["batch"], spec["seq"]
    shape = WorkloadShape("train_4k_b1", s, b, "train")
    mesh = make_host_mesh()
    defs = api.param_defs(cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size), b, s,
                       device="cuda")
    batches = [data.batch_at(i) for i in range(spec["steps"])]

    def whole(x):
        return x.full_tensor() if type(x).__name__ == "DTensor" else x

    def run(m, policy: str, steps: int, eager: bool = False) -> dict:
        step_cfg = StepConfig(use_flash=True, flash_block_q=tile[0],
                              flash_block_k=tile[1], remat=True,
                              remat_policy=policy)
        bundle = build_train_step(cfg, shape, m, step_cfg=step_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the step's own memory: its arguments and what it allocates,
        # not what this process holds already
        base = torch.cuda.memory_allocated()
        params = materialize(torch.Generator(device="cuda").manual_seed(0),
                             defs)
        opt = adamw_init(defs, "cuda")
        fn = bundle.jitted()
        kernels.reset_launch_counts()
        metrics, step_ms = [], []
        with graphs.disabled() if eager else contextlib.nullcontext():
            for i in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, mt = fn(params, opt, batches[i], i)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: whole(v).clone() for k, v in mt.items()})
        fn.release()
        out = {"metrics": metrics, "step_ms": step_ms,
               "peak_bytes": torch.cuda.max_memory_allocated() - base,
               "launches": kernels.launch_counts(),
               "routes": dict(kernels.flash_attention.route_launches),
               "dtensor": type(next(iter(flatten(params).values())))
               .__name__ == "DTensor",
               "params": {k: whole(v) for k, v in flatten(params).items()}}
        if m is not None:
            out["estimate"] = bundle.lower().peak_bytes
        return out

    eager = run(None, "nothing_saveable", spec["steps"], eager=True)
    plain = run(None, "nothing_saveable", spec["steps"])
    plain_params = plain.pop("params")
    sharded = run(mesh, "nothing_saveable", spec["steps"])
    eager2 = run(None, "nothing_saveable", spec["steps"], eager=True)
    if not sharded["dtensor"]:
        fail("the sharded step's parameters are not DTensors")
    # the captured meshless steps against the eager ones, within the
    # spread of the two eager runs (0 where eager is bitwise repeatable)
    gaps = {}
    for key in ("loss", "grad_norm"):
        gaps[key] = tuple(
            max(float((x[i][key] - y[i][key]).abs()) for i in
                range(spec["steps"]))
            for x, y in ((plain["metrics"], eager["metrics"]),
                         (eager2["metrics"], eager["metrics"])))
    gaps["params"] = tuple(
        max(float((x[k].float() - eager["params"][k].float()).abs().max())
            for k in x)
        for x in (plain_params, eager2["params"]))
    for key, (gap, spread) in gaps.items():
        if not gap <= spread:
            fail(f"captured meshless steps: {key} differs from the eager "
                 f"steps' by {gap}, more than the spread of two eager runs "
                 f"({spread})")
    for i, (a, c) in enumerate(zip(plain["metrics"], sharded["metrics"])):
        for key in ("loss", "grad_norm"):
            if not torch.equal(a[key], c[key]):
                fail(f"sharded step {i}: {key} {float(c[key])!r} vs meshless "
                     f"{float(a[key])!r}")
    diff = [k for k, v in sharded.pop("params").items()
            if not torch.equal(v, plain_params[k])]
    if diff:
        fail(f"sharded steps: final parameters differ from the meshless "
             f"ones at {diff[:5]}")
    del plain_params
    flash = sharded["launches"]["flash_attention"]
    per_step = 2 * spec["layers"]          # forward + remat recompute
    if flash != per_step * spec["steps"] or \
            sharded["routes"]["tensor_cores"] != flash:
        fail(f"sharded steps: flash launches {flash}, routes "
             f"{sharded['routes']}; want {per_step} a step, all on the "
             f"tensor cores")
    ratio = sharded["estimate"] / sharded["peak_bytes"]
    if not PEAK_ESTIMATE[0] <= ratio <= PEAK_ESTIMATE[1]:
        fail(f"the dry run's peak estimate {sharded['estimate']} bytes is "
             f"{ratio:.3f}x the measured {sharded['peak_bytes']}")
    print(f"{cfg.name} at full width ({spec['layers']} of 40 layers, B={b}, "
          f"S={s}, bf16, flash tile {tile}, remat) on make_host_mesh() "
          f"{tuple(mesh.shape)} with TRAIN_RULES: {spec['steps']} steps "
          f"bitwise equal to mesh=None (losses "
          + ", ".join(f"{float(m['loss']):.6f}" for m in sharded["metrics"])
          + ", global norms "
          + ", ".join(f"{float(m['grad_norm']):.6f}"
                      for m in sharded["metrics"]) + ", final params)")
    print(f"  captured meshless vs eager meshless, max abs difference "
          f"(eager vs eager again): "
          + ", ".join(f"{k} {g:.3e} ({sp:.3e})"
                      for k, (g, sp) in gaps.items()))
    print(f"  step ms (each; captured: the first eager, the second "
          f"captured): sharded captured "
          + ", ".join(f"{t:.1f}" for t in sharded["step_ms"])
          + "; meshless captured "
          + ", ".join(f"{t:.1f}" for t in plain["step_ms"])
          + "; meshless eager "
          + ", ".join(f"{t:.1f}" for t in eager["step_ms"])
          + "; meshless eager again "
          + ", ".join(f"{t:.1f}" for t in eager2["step_ms"]))
    print(f"  replayed step (mean after the capture): sharded "
          f"{statistics.mean(sharded['step_ms'][2:]):.1f} ms, meshless "
          f"{statistics.mean(plain['step_ms'][2:]):.1f} ms; eager meshless "
          f"{statistics.mean(eager['step_ms'][1:] + eager2['step_ms'][1:]):.1f}"
          f" ms (mean after the first)")
    print(f"  peak memory: sharded {sharded['peak_bytes'] / 2 ** 30:.3f} GiB,"
          f" meshless {plain['peak_bytes'] / 2 ** 30:.3f} GiB (captured), "
          f"meshless eager {eager['peak_bytes'] / 2 ** 30:.3f} GiB; the dry "
          f"run's "
          f"estimate on meta {sharded['estimate'] / 2 ** 30:.3f} GiB "
          f"({ratio:.3f}x the measured)")
    print(f"  flash launches {flash} ({per_step} a step), routes "
          f"{sharded['routes']}")
    policies, runs_by_policy = {}, {}
    first = None                 # the parameters after nothing_saveable's step
    for policy in DIST_POLICIES:
        r = run(mesh, policy, 1)
        runs_by_policy[policy] = r
        updated = r.pop("params")
        for key in ("loss", "grad_norm"):
            if not torch.equal(r["metrics"][0][key],
                               sharded["metrics"][0][key]):
                fail(f"remat {policy}: {key} {float(r['metrics'][0][key])!r}"
                     f" vs nothing_saveable's "
                     f"{float(sharded['metrics'][0][key])!r}")
        if first is None:
            first = updated
        else:
            # the same gradients give the same AdamW update
            diff = [k for k, v in updated.items()
                    if not torch.equal(v, first[k])]
            if diff:
                fail(f"remat {policy}: parameters after one step differ "
                     f"from nothing_saveable's at {diff[:5]}")
        del updated
        policies[policy] = {"peak_bytes": r["peak_bytes"],
                            "step_ms": r["step_ms"][0],
                            "flash": r["launches"]["flash_attention"]}
        print(f"  remat {policy}: loss, global norm and updated parameters "
              f"equal to nothing_saveable's; peak "
              f"{r['peak_bytes'] / 2 ** 30:.3f} GiB,"
              f" step {r['step_ms'][0]:.1f} ms (first), flash launches "
              f"{r['launches']['flash_attention']}")
    if not policies["nothing_saveable"]["peak_bytes"] < \
            policies["everything_saveable"]["peak_bytes"]:
        fail(f"remat: nothing_saveable's peak is not below "
             f"everything_saveable's ({policies})")
    runs = [sharded] + list(runs_by_policy.values())
    return {"sharded": {k: v for k, v in sharded.items() if k != "metrics"},
            "plain": {k: v for k, v in plain.items() if k != "metrics"},
            "eager": {k: v for k, v in eager.items()
                      if k not in ("metrics", "params")},
            "eager_gaps": gaps,
            "losses": [float(m["loss"]) for m in sharded["metrics"]],
            "policies": policies, "estimate_ratio": ratio,
            "launches": {k: sum(r["launches"][k] for r in runs)
                         for k in sharded["launches"]},
            "routes": {k: sum(r["routes"][k] for r in runs)
                       for k in sharded["routes"]}}


def distributed_tuner_bench() -> dict:
    """Phase 16 (e): the ``distributed_tuner`` bench through
    ``bench.run``'s own runner in this process: 5 backend rows and 6
    strategy rows with finite GFLOP/s, and the hand GEMM launched."""
    import math
    from repro_torch import kernels
    from repro_torch.bench import run as bench_run
    from repro_torch.bench.distributed_tuner import BACKENDS, STRATEGIES
    print("$ repro_torch.bench.run --only distributed_tuner (in process)",
          flush=True)
    kernels.reset_launch_counts()
    rows = bench_run.run_benches(["distributed_tuner"])["distributed_tuner"]
    launches = kernels.launch_counts()
    routes = dict(kernels.flash_attention.route_launches)
    backends = [r for r in rows if "backend" in r]
    strategies = [r for r in rows if "strategy" in r]
    if [r["backend"] for r in backends] != list(BACKENDS) or \
            [r["strategy"] for r in strategies] != list(STRATEGIES):
        fail(f"distributed_tuner rows: {rows}")
    if not all(math.isfinite(r["gflops"]) and r["gflops"] > 0
               for r in rows):
        fail(f"distributed_tuner: non-finite GFLOP/s in {rows}")
    if launches["matmul"] == 0:
        fail("the distributed_tuner bench never launched the GEMM kernel")
    print(f"  distributed_tuner: {len(backends)} backend rows, "
          f"{len(strategies)} strategy rows; GEMM kernel launches "
          f"{launches['matmul']}")
    return {"rows": rows, "launches": launches, "routes": routes}


def distribution_path(tile: tuple[int, int]) -> dict:
    """Phase 16: the dry runs and the perf driver in processes of their
    own (host CPU only), beside the sharded steps on the card (c, d) and
    the distributed tuner bench (e), which times on the card's clock;
    then the dry runs' checks. The phase's launches (the sharded steps'
    and the bench's) are summed per wrapper and per flash route: the f32
    flash routes and the SSD scan, which no part of it runs, must stay
    at 0."""
    running = start_dry_runs()
    steps = sharded_steps(tile)
    bench = distributed_tuner_bench()
    dry = dry_run_checks(running)
    launches = {k: steps["launches"][k] + bench["launches"][k]
                for k in steps["launches"]}
    routes = {k: steps["routes"][k] + bench["routes"][k]
              for k in steps["routes"]}
    stray = {k: n for k, n in (("tf32x3", routes["tf32x3"]),
                               ("tf32x3_d256", routes["tf32x3_d256"]),
                               ("ssd_chunk_scan",
                                launches["ssd_chunk_scan"])) if n}
    if stray:
        fail(f"distribution: launches where the phase runs none: {stray}")
    print(f"  distribution launches: {launches}, flash routes {routes}")
    return {"dry": dry, "steps": steps, "bench": bench,
            "launches": launches, "routes": routes}


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
    from repro_torch.kernels.matmul import BF16_TILES, TILES
    from repro_torch.kernels.matmul import smem_bytes as gemm_smem_bytes
    from repro_torch.kernels.flash_attention import (SM90_TILES,
                                                     TF32X3_D256_TILES,
                                                     TF32X3_TILES,
                                                     attention_ref,
                                                     bytes_moved,
                                                     flash_attention,
                                                     sm90_smem_bytes,
                                                     tf32x3_smem_bytes)
    from repro_torch.kernels.flash_attention import flops as flash_flops
    from repro_torch.kernels.flash_attention import \
        smem_bytes as flash_smem_bytes
    from repro_torch.kernels.triad import triad, triad_ref
    from repro_torch.bench.common import model_step_space
    from repro_torch.bench.ssd_probe import kernel_ms
    from repro_torch.kernels.ssd import (chunk_scan,
                                         kernel_info as ssd_kernel_info,
                                         ssd_chunk_scan_ref)
    from repro_torch.models.layers import _attend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 2. build ----------------------------------------------------------
    phase("build")
    fresh = not build.library_path().exists()
    t0 = time.perf_counter()
    baselines = {
        "mma.sync SSD": start_baseline_build(nvcc, "ssd_mma_sync.cu",
                                             "libssdmmasync.so"),
        "CUDA-core GEMM": start_baseline_build(
            nvcc, "matmul_cuda_cores.cu", "libmatmulcudacores.so")}
    build.library()
    print(f"kernel library {build.library_path()} "
          f"({'built' if fresh else 'found'} in "
          f"{time.perf_counter() - t0:.2f}s)")
    for label, (proc, path) in baselines.items():
        out = proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)[0]
        if proc.returncode != 0:
            print(out)
            fail(f"the {label} baseline did not build")
        print(f"{label} baseline {path.name} built in "
              f"{time.perf_counter() - t0:.2f}s (with the library)")
    ssd_baseline = ssd_baseline_fn(baselines["mma.sync SSD"][1])
    gemm_baseline = baselines["CUDA-core GEMM"][1]
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
        print(f"  flash f32 CUDA-core kernel d={d} (replaced, on no route): "
              f"{flash_smem_bytes(d)} bytes dynamic shared memory per block "
              f"(opt-in limit {limit})")
    lib = build.library()
    for kind, query, wrapper_tiles in (
            ("bf16", "rt_flash_attention_sm90_tiles", SM90_TILES),
            ("tf32x3", "rt_flash_attention_tf32x3_tiles", TF32X3_TILES),
            ("tf32x3_d256", "rt_flash_attention_tf32x3_d256_tiles",
             TF32X3_D256_TILES)):
        table = (ctypes.c_int * 300)()
        n_tiles = getattr(lib, query)(table, 100)
        compiled = {tuple(table[3 * i:3 * i + 3]) for i in range(n_tiles)}
        if compiled != {(d, qt, kt) for d, tiles in wrapper_tiles.items()
                        for qt, kt in tiles}:
            fail(f"the library's {kind} flash tiles {sorted(compiled)} are "
                 f"not the wrapper's")
    for d, tiles in {**TF32X3_TILES, **TF32X3_D256_TILES}.items():
        for qt, kt in tiles:
            # the label may follow digits of the mangled namespace
            label = (f"flash_attention_tf32x3_d256_kernel<f32,{qt},{kt}>: "
                     if d in TF32X3_D256_TILES else
                     f"flash_attention_tf32x3_kernel<f32,{d},{qt},{kt}>: ")
            rows = [row.split(label, 1)[1] for row in ptxas_rows
                    if label in row]
            print(f"  flash f32 tf32x3 d={d} tile {qt}x{kt}: "
                  f"{tf32x3_smem_bytes(d, qt, kt)} bytes dynamic shared "
                  f"memory per block; "
                  + ("; ".join(rows) or "not in the build log"))
    for d, tiles in SM90_TILES.items():
        print(f"  flash bf16 d={d}: dynamic shared memory per block " + ", ".join(
            f"{qt}x{kt} {sm90_smem_bytes(d, qt, kt)}" for qt, kt in tiles))
    gemm_info = f32_gemm_build(lib, ptxas_rows)
    table = (ctypes.c_int * 300)()
    n_tiles = lib.rt_matmul_sm90_tiles(table, 100)
    if [tuple(table[3 * i:3 * i + 3]) for i in range(n_tiles)] != \
            list(BF16_TILES):
        fail("the library's bf16 GEMM tiles are not the wrapper's BF16_TILES")
    lib.rt_matmul_sm90_smem_bytes.restype = ctypes.c_int64
    sm90_bad = [line.strip() for line in text.splitlines()
                if "C7520" in line and "matmul_sm90" in line] \
        if log.exists() else ["no build log"]
    for t in BF16_TILES:
        smem = lib.rt_matmul_sm90_smem_bytes(*t)
        if smem != gemm_smem_bytes(*t, torch.bfloat16):
            fail(f"matmul bf16 {t}: the library asks {smem} bytes of shared "
                 f"memory, the wrapper's formula "
                 f"{gemm_smem_bytes(*t, torch.bfloat16)}")
        label = f"matmul_sm90_kernel<bf16,{t[0]},{t[1]},{t[2]}>: "
        rows = [row.split(label, 1)[1] for row in ptxas_rows if label in row]
        sm90_bad += [f"{label}{row}" for row in rows
                     if ", 0 bytes spill stores" not in row]
        if not rows:
            sm90_bad.append(f"{label}not in the build log")
        print(f"  matmul bf16 tensor cores {'x'.join(map(str, t))}: {smem} "
              f"bytes dynamic shared memory per block; " + "; ".join(rows))
    if sm90_bad:
        fail(f"the bf16 tensor-core GEMM spills or has serialised wgmma "
             f"(C7520): {sm90_bad}")
    for name, info in ssd_kernel_info().items():
        rows = [row for row in ptxas_rows if row.startswith(name + "<")]
        print(f"  {name}: {info['threads']} threads, {info['smem_bytes']} "
              f"bytes dynamic shared memory and {info['blocks_per_sm']} "
              f"blocks per SM (any N); " + ("; ".join(
                  row.split(", 0 bytes stack")[0] + (
                      "" if ", 0 bytes spill stores" in row else " SPILLS")
                  for row in rows) or "not in the build log"))
    ssd_bad = [line.strip() for line in text.splitlines()
               if "C7520" in line and "_ssd_cu_" in line] \
        if log.exists() else ["no build log"]
    ssd_bad += [row for row in ptxas_rows if row.startswith("ssd_")
                and ", 0 bytes spill stores" not in row]
    if ssd_bad:
        fail(f"an SSD kernel spills or has serialised wgmma (C7520): "
             f"{ssd_bad}")

    # -- 3. checks ---------------------------------------------------------
    phase("kernel checks")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev).to(dtype)

    errs = {"triad": 0.0}
    n_checks = {"triad": 0, "flash_attention": 0, "ssd_chunk_scan": 0}
    n_checks["matmul"], errs["matmul"] = f32_gemm_checks(randn, gemm_baseline)
    n_checks["matmul_bf16"], errs["matmul_bf16"] = bf16_gemm_checks(randn)
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
    gemm = f32_gemm_times(randn, gemm_baseline)
    gemm16 = bf16_gemm_times(randn, gemm_baseline)
    torch.cuda.empty_cache()

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
    f32_ms = {tile: cuda_ms(lambda t=tile: flash_attention(
        *f32_ops, causal=True, bq=t[0], bk=t[1]), iters=5, warmup=1)
        for tile in quick_tiles}
    f32_tile = min(f32_ms, key=f32_ms.get)
    errs["flash_f32_main"] = max(errs["flash_f32_main"], check_close(
        f"flash {FLASH_MAIN} f32 tile {f32_tile}", flash_attention(
            *f32_ops, causal=True, bq=f32_tile[0], bk=f32_tile[1]),
        want, FLASH_MAIN_TOL["f32"]))
    # the CUDA-core kernel this one replaced, still compiled (on no
    # route): checked, then timed on the same operands
    was = cuda_core_flash(fd)
    errs["flash_f32_was"] = check_close(
        f"flash {FLASH_MAIN} f32 CUDA-core kernel", was(*f32_ops, *f32_tile),
        want, FLASH_MAIN_TOL["f32"])
    del want
    flash32 = {
        "kernel": f32_ms[f32_tile],
        "was": cuda_ms(lambda: was(*f32_ops, *f32_tile), iters=3, warmup=1),
        "plain": cuda_ms(lambda: attention_ref(*f32_ops, causal=True),
                         iters=2, warmup=1),
        "library": cuda_ms(lambda: torch.nn.functional
                           .scaled_dot_product_attention(
                               *f32_ops, is_causal=True, enable_gqa=True),
                           iters=5, warmup=1),
        "bound": max(flash["flops"] / TF32X3_PEAK,
                     2 * flash["bytes"] / HBM_PEAK) * 1e3,
        "bound_cuda_cores": max(flash["flops"] / F32_PEAK,
                                2 * flash["bytes"] / HBM_PEAK) * 1e3}
    for tile, ms in f32_ms.items():
        print(f"flash f32 tile {tile}: {ms:.4f} ms  "
              f"{flash['flops'] / ms / 1e9:.2f} TFLOP/s")
    print(f"flash {FLASH_MAIN} f32 causal (3xTF32 on the tensor cores): "
          f"kernel {flash32['kernel']:.4f} ms (tile {f32_tile}, "
          f"{flash['flops'] / flash32['kernel'] / 1e9:.2f} TFLOP/s, "
          f"{flash32['bound'] / flash32['kernel']:.1%} of its bound) | was "
          f"{flash32['was']:.4f} ms (CUDA-core kernel, same run; "
          f"{flash32['was'] / flash32['kernel']:.2f}x) | bound "
          f"{flash32['bound']:.4f} ms (FLOPs / 165 TFLOP/s, 3xTF32), "
          f"{flash32['bound_cuda_cores']:.4f} ms (FLOPs / 67 TFLOP/s, CUDA "
          f"cores) | plain {flash32['plain']:.4f} ms | "
          f"scaled_dot_product_attention {flash32['library']:.4f} ms | max "
          f"abs err {errs['flash_f32_main']:.3e} (CUDA-core kernel "
          f"{errs['flash_f32_was']:.3e})")
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
    # gemma-2b's widths: the f32 D = 256 kernel beside the CUDA-core kernel
    # it replaced, then bf16 on the tensor-core kernel
    d256 = flash_d256_times(randn, quick_tiles)
    flash256, bf16_256 = d256["f32"], d256["bf16"]
    errs["flash_f32_d256"] = flash256["max_abs_err"]
    errs["flash_f32_d256_was"] = flash256["max_abs_err_was"]
    errs["flash_attention"] = max(errs["flash_attention"],
                                  bf16_256["max_abs_err"])
    n_checks["flash_attention"] += len(quick_tiles)
    del d256
    torch.cuda.empty_cache()
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
        want_y, want_h = ssd_chunk_scan_ref(xdt, bm, cm, cum,
                                            return_state=True)
        was_y, was_h = ssd_baseline(xdt, bm, cm, cum)
        check_close(f"ssd {label} mma.sync baseline y", was_y, want_y,
                    ssd_tol(want_y))
        check_close(f"ssd {label} mma.sync baseline state", was_h, want_h,
                    ssd_tol(want_h))
        del want_y, want_h, was_y, was_h
        cost = ssd_shape_cost(shape)
        with torch.no_grad():
            # the shipped kernel and the design it replaced in turns
            # (kernel, was, was, kernel), each the mean of its two
            turns = [cuda_ms(lambda: chunk_scan(
                         xdt, bm, cm, cum, return_state=True), iters=10,
                         warmup=2),
                     cuda_ms(lambda: ssd_baseline(xdt, bm, cm, cum),
                             iters=5, warmup=1)]
            turns += [cuda_ms(lambda: ssd_baseline(xdt, bm, cm, cum),
                              iters=5, warmup=1),
                      cuda_ms(lambda: chunk_scan(
                          xdt, bm, cm, cum, return_state=True), iters=10,
                          warmup=2)]
            t = {"kernel": (turns[0] + turns[3]) / 2,
                 "was": (turns[1] + turns[2]) / 2, "turns": turns,
                 "plain": cuda_ms(lambda: ssd_chunk_scan_ref(
                     xdt, bm, cm, cum, return_state=True), iters=2,
                     warmup=1)}
            parts_ms = kernel_ms(lambda: chunk_scan(
                xdt, bm, cm, cum, return_state=True))
        ssd_time[label] = {**t, **cost, "shape": shape, "parts": parts_ms}
        print(f"ssd {label} (B, H, C, Q, P, N)={shape} f32: kernel "
              f"{t['kernel']:.4f} ms ({cost['flops'] / t['kernel'] / 1e9:.2f} "
              f"TFLOP/s of the formula's {cost['flops'] / 1e9:.1f} GFLOP, "
              f"{cost['needed'] / t['kernel'] / 1e9:.2f} of the needed "
              f"{cost['needed'] / 1e9:.2f}; {t['was'] / t['kernel']:.2f}x "
              f"faster than the mma.sync design's {t['was']:.4f} ms) | "
              f"bound {cost['bound']:.4f} ms at {TF32X3_PEAK / 1e12:.0f} "
              f"TFLOP/s, 3xTF32 ({cost['bound_by']}; "
              f"{cost['bound'] / t['kernel']:.1%} of it), "
              f"{cost['bound_cuda_cores']:.4f} ms at "
              f"{F32_PEAK / 1e12:.0f} TFLOP/s, CUDA cores "
              f"({cost['bound_by_cuda_cores']}); {cost['bytes'] / 1e9:.4f} "
              f"GB / 3.35 TB/s | plain {t['plain']:.4f} ms | library: none "
              f"(no PyTorch call computes the chunk scan)")
        print("  turns (kernel, was, was, kernel) " + ", ".join(
            f"{x:.4f}" for x in turns) + " ms")
        print("  blocks " + ", ".join(f"{k} {v}" for k, v in
                                      cost["blocks"].items())
              + "; work items " + ", ".join(f"{k} {v}" for k, v in
                                            cost["items"].items()))
        print("  device ms per kernel (torch.profiler) " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts_ms.items()))
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

    # -- 6b. gemma-2b's f32 step ----------------------------------------------
    phase("model step in float32 at D = 256 (gemma-2b, 2 of 18 layers, B=1, "
          "S=4096)")
    gemma = gemma_f32_step(step["tile"])

    # -- 7. full depth -------------------------------------------------------
    phase("full-depth step (granite-3-2b, 40 layers, B=1, S=4096)")
    deep = full_depth_step(step["tile"])

    # -- 8. serving -----------------------------------------------------------
    phase("serving (mamba2-130m 4 x 32768-token prefill; granite-3-2b and "
          "zamba2-2.7b through serve, 4 x 4096 + 32; decode eager and "
          "captured; "
          "32k-context decode)")
    serving = serving_path()
    errs["continue"] = decode_continues_prefill()
    served_models = dense_and_hybrid_serving()
    errs["serve_continue"] = served_models["continue"]

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

    # -- 10. device timing ----------------------------------------------------
    phase("device timing (torch.profiler, traced sessions)")
    kernels.reset_launch_counts()
    timing = device_timing_path(triad_ms)
    timing_launches = kernels.launch_counts()
    if timing_launches["triad"] == 0:
        fail("the device-timing sessions never launched the triad kernel")

    # -- 11. paper tables ------------------------------------------------------
    phase("paper tables (Tables IV-XI, Fig. 6), harness, backends")
    tables = paper_tables_path()

    # -- 12. history and search ------------------------------------------------
    phase("history and search (ledger, gate, surrogate, bandit, sweep, "
          "dashboard)")
    search = history_search_path(report.dgemm.score)

    # -- 13. observability and lint ---------------------------------------------
    phase("observability and lint (ops, linter, audit, attribution)")
    observe = observability_path(step["tile"])

    # -- 14. model stack -------------------------------------------------------
    phase("model stack (granite-moe-1b-a400m, mixtral-8x22b, "
          "llama-3.2-vision-11b, whisper-base at full width)")
    stack = model_stack_path(step["tile"], quick_tiles)
    stack_flash = {label: run["flash"]["launches"]["flash_attention"]
                   for label, run in stack["train"].items()}
    d128 = stack["flash"]["d128"]

    # -- 15. training launch ---------------------------------------------------
    phase("training launch (mamba2-130m through launch.train: 40 steps, "
          "20 + resume to 40, two eager runs of 6; granite-3-2b at 40 "
          "layers, 7 AdamW steps eager and captured)")
    training = training_launch_path(step["tile"])
    dense_train = training["dense"]
    launcher_runs = training["launcher"]["runs"]

    # -- 16. distribution ------------------------------------------------------
    phase("distribution (dry runs on fake worlds, launch.perf, granite-3-2b "
          "sharded steps on the host mesh, remat policies, distributed tuner)")
    dist = distribution_path(step["tile"])

    # -- result lines ------------------------------------------------------
    phase("result")
    print(f"total wall {time.perf_counter() - t_start:.1f}s")
    t_srv, t_hyb = ssd_time["mamba2 serving"], ssd_time["zamba2 train"]
    t_lt = ssd_time["mamba2 train"]
    zamba2_serve_ssd = served_models["zamba2"]["launches"]["ssd_chunk_scan"]
    print(card_line())
    t_dram = triad_ms["dram"]
    print(json.dumps({"kernels": [
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/matmul_f32_sm90.cu",
         "replaces": "src/repro/kernels/matmul/matmul.py:27",
         "launches": launches["matmul"],
         "launches_paper_tables": tables["routes"]["cuda_cores"],
         "launches_history_search": search["launches"],
         "launches_observability": (
             observe["tune_launches"]["gemm_tiled"]["matmul"]),
         "launches_distribution": dist["launches"]["matmul"],
         "max_abs_err": errs["matmul"],
         "ms": gemm["ms"], "plain_ms": gemm["plain"],
         "bound_ms": gemm["bound"], "bound_by": gemm["bound_by"],
         "library_ms": gemm["library"], "checks_passed": n_checks["matmul"],
         "shape": list(GEMM_MAIN), "tile": list(gemm["tile"]),
         "tile_ms": {"x".join(map(str, t)): ms
                     for t, ms in gemm["tile_ms"].items()},
         "was_ms": gemm["was"], "was_tile": list(gemm["was_tile"]),
         "was_tile_ms": {"x".join(map(str, t)): ms
                         for t, ms in gemm["was_ms"].items()},
         "was_source":
             "src/repro_torch/csrc/baseline/matmul_cuda_cores.cu",
         "host_us_per_launch": gemm["host_us"],
         "was_host_us_per_launch": gemm["was_host_us"],
         "build": {"x".join(map(str, t)): {
             key: v for key, v in row.items() if key != "ptxas"}
             for t, row in gemm_info.items()},
         "dtype": "float32"},
        {"name": "matmul_bf16", "route": "cuda",
         "source": "src/repro_torch/csrc/matmul_sm90.cu",
         "replaces": "src/repro/kernels/matmul/matmul.py:27",
         "launches": tables["benches"]["kernel_autotune"]["bf16"][
             "launches"]["tensor_cores"],
         "launches_paper_tables": tables["routes"]["tensor_cores"],
         "launches_cuda_cores": tables["benches"]["kernel_autotune"][
             "bf16"]["launches"]["cuda_cores"],
         "max_abs_err": max(errs["matmul_bf16"], gemm16["err"]),
         "max_abs_err_was": gemm16["was_err"],
         "ms": gemm16["ms"], "was_ms": gemm16["was"],
         "was_source":
             "src/repro_torch/csrc/baseline/matmul_cuda_cores.cu",
         "was_tile": list(gemm16["was_tile"]),
         "plain_ms": gemm16["plain"], "bound_ms": gemm16["bound"],
         "bound_by": gemm16["bound_by"], "library_ms": gemm16["library"],
         "checks_passed": n_checks["matmul_bf16"],
         "shape": list(GEMM_MAIN), "tile": list(gemm16["tile"]),
         "tile_ms": {"x".join(map(str, t)): ms
                     for t, ms in gemm16["tile_ms"].items()},
         "search_best": tables["benches"]["kernel_autotune"]["bf16"]["best"],
         "dtype": "bfloat16", "tensor_cores": True},
        {"name": "triad", "route": "cuda",
         "source": "src/repro_torch/csrc/triad.cu",
         "replaces": "src/repro/kernels/triad/triad.py:26",
         "launches": launches["triad"],
         "launches_device_timing": timing_launches["triad"],
         "launches_paper_tables": tables["launches"]["triad"],
         "launches_observability": (
             observe["tune_launches"]["triad"]["triad"]),
         "launches_distribution": dist["launches"]["triad"],
         "host_us_per_call": observe["ops"]["host_us"],
         "profiled_ms": {label: run["timings"][0][1]["device_time_s"] * 1e3
                         for label, run in timing.items()
                         if label in DEVICE_TIMING_TRIAD},
         "profiler_lost": timing["lost"],
         "max_abs_err": errs["triad"],
         "ms": t_dram["kernel"], "plain_ms": t_dram["plain"],
         "bound_ms": t_dram["bound"], "bound_by": "bytes",
         "library_ms": t_dram["library"], "checks_passed": n_checks["triad"],
         "n": t_dram["n"], "dtype": "float32"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:33",
         "launches": (step["routes"]["tensor_cores"]
                      + hyb["routes"]["tensor_cores"]
                      + sum(stack_flash.values())),
         "launches_granite_step": step["routes"]["tensor_cores"],
         "launches_zamba2_step": hyb["routes"]["tensor_cores"],
         "launches_model_stack": stack_flash,
         "launches_training": dense_train["launches"]["flash_attention"],
         "launches_distribution": dist["routes"]["tensor_cores"],
         "launches_observability": (
             observe["launches"]["granite"]["flash_attention"]
             + observe["launches"]["zamba2"]["flash_attention"]),
         "attributed_ms": {
             label: observe["reports"][label]["kernel_op_ms"][
                 "flash_attention_fwd"] for label in ("granite", "zamba2")},
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
         "d256": {"shape": list(FLASH_D256), "tile": list(bf16_256["tile"]),
                  "ms": bf16_256["kernel"],
                  "tile_ms": {f"{t[0]}x{t[1]}": ms for t, ms in
                              bf16_256["tile_ms"].items()},
                  "bound_ms": bf16_256["bound"],
                  "bound_by": bf16_256["bound_by"],
                  "library_ms": bf16_256["library"]},
         "d128": {"shape": list(d128["shape"]), "tile": list(d128["tile"]),
                  "ms": d128["kernel"],
                  "tile_ms": {f"{t[0]}x{t[1]}": ms for t, ms in
                              d128["tile_ms"].items()},
                  "plain_ms": d128["plain"], "bound_ms": d128["bound"],
                  "bound_by": d128["bound_by"],
                  "library_ms": d128["library"],
                  "max_abs_err": d128["max_abs_err"]},
         "model_stack_max_abs_err": stack["flash"]["errs"],
         "dtype": "bfloat16", "causal": True, "tensor_cores": True,
         "model_step_ms": step["step_ms"][(1, *step["tile"])],
         "model_step_eager_vs_captured": step["compare"],
         "full_depth_step_ms": deep["step_ms"],
         "full_depth_peak_gib": deep["peak_gib"],
         "model_stack": {
             "train": {label: {k: run[k] for k in
                               ("plain", "flash", "loss_rel")}
                       for label, run in stack["train"].items()},
             "serve": {label: {k: v for k, v in run.items()
                               if k != "launches"}
                       for label, run in stack["serve"].items()},
             "continue": stack["continue"]},
         "distribution": {
             "arch": DIST_STEP["arch"], "layers": DIST_STEP["layers"],
             "sharded_step_ms": dist["steps"]["sharded"]["step_ms"],
             "meshless_step_ms": dist["steps"]["plain"]["step_ms"],
             "meshless_eager_step_ms": dist["steps"]["eager"]["step_ms"],
             "meshless_eager_peak_gib": (
                 dist["steps"]["eager"]["peak_bytes"] / 2 ** 30),
             "captured_vs_eager": dist["steps"]["eager_gaps"],
             "sharded_peak_gib": (dist["steps"]["sharded"]["peak_bytes"]
                                  / 2 ** 30),
             "meshless_peak_gib": (dist["steps"]["plain"]["peak_bytes"]
                                   / 2 ** 30),
             "estimate_ratio": dist["steps"]["estimate_ratio"],
             "losses": dist["steps"]["losses"],
             "remat": dist["steps"]["policies"],
             "dry_run": {"granite": {k: dist["dry"]["granite"][k] for k in
                                     ("compute_ms", "memory_ms",
                                      "collective_ms", "peak_gb",
                                      "compile_s")},
                         "seconds": dist["dry"]["seconds"]}},
         "training": {"arch": TRAIN_DENSE["arch"],
                      "step_ms": dense_train["step_ms"],
                      "step_ms_each": dense_train["step_ms_each"],
                      "update_ms": dense_train["update_ms"],
                      "grad_norm": dense_train["grad_norm"],
                      "losses": dense_train["result"]["losses"],
                      "captured_step_ms": dense_train["captured_step_ms"],
                      "eager_peak_gib": dense_train["eager_peak_gib"],
                      "captured_peak_gib": dense_train["captured_peak_gib"],
                      "reserved_gib": dense_train["reserved_gib"],
                      "modes": list(TRAIN_DENSE["modes"]),
                      "flash_per_step": dense_train["flash_per_step"]}},
        {"name": "flash_attention_f32", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_tf32x3.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:33",
         "launches": step["f32_launches"],
         "launches_distribution": dist["routes"]["tf32x3"],
         "launches_granite_f32_step": step["f32_launches"],
         "max_abs_err": errs["flash_f32_main"],
         "max_abs_err_f32_cases": errs["flash_f32_cases"],
         "max_abs_err_was": errs["flash_f32_was"],
         "ms": flash32["kernel"], "was_ms": flash32["was"],
         "was_source": "src/repro_torch/csrc/flash_attention.cu",
         "plain_ms": flash32["plain"],
         "bound_ms": flash32["bound"], "bound_by": "operations",
         "bound_ms_cuda_cores": flash32["bound_cuda_cores"],
         "library_ms": flash32["library"], "shape": list(FLASH_MAIN),
         "tile": list(f32_tile), "dtype": "float32", "causal": True,
         "tensor_cores": True, "products": "3xTF32",
         "f32_loss_rel": step["f32_loss_rel"],
         "f32_step_ms": step["f32_step_ms"]},
        {"name": "flash_attention_f32_d256", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_tf32x3_d256.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:33",
         "launches": gemma["f32_launches"],
         "launches_gemma_f32_step": gemma["f32_launches"],
         "launches_distribution": dist["routes"]["tf32x3_d256"],
         "max_abs_err": errs["flash_f32_d256"],
         "max_abs_err_was": errs["flash_f32_d256_was"],
         "ms": flash256["kernel"], "was_ms": flash256["was"],
         "was_source": "src/repro_torch/csrc/flash_attention.cu",
         "plain_ms": flash256["plain"],
         "bound_ms": flash256["bound"], "bound_by": flash256["bound_by"],
         "bound_ms_cuda_cores": flash256["bound_cuda_cores"],
         "library_ms": flash256["library"], "shape": list(FLASH_D256),
         "tile": list(flash256["tile"]),
         "tile_ms": {f"{t[0]}x{t[1]}": ms
                     for t, ms in flash256["tile_ms"].items()},
         "dtype": "float32", "causal": True, "tensor_cores": True,
         "products": "3xTF32", "f32_loss_rel": gemma["f32_loss_rel"],
         "f32_step_ms": gemma["f32_step_ms"]},
        {"name": "ssd_chunk_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd.cu",
         "replaces": "src/repro/kernels/ssd/ssd.py:36",
         "launches": (serving["launches"] + zamba2_serve_ssd
                      + hyb["launches"]["ssd_chunk_scan"]),
         "launches_serving": serving["launches"] + zamba2_serve_ssd,
         "launches_serving_mamba2": serving["launches"],
         "launches_serving_zamba2": zamba2_serve_ssd,
         "launches_zamba2_step": hyb["launches"]["ssd_chunk_scan"],
         "launches_training": training["launcher"]["ssd_launches"],
         "launches_distribution": dist["launches"]["ssd_chunk_scan"],
         "launches_observability": (
             observe["launches"]["mamba2"]["ssd_chunk_scan"]
             + observe["launches"]["zamba2"]["ssd_chunk_scan"]),
         "attributed_ms": {
             label: observe["reports"][label]["kernel_op_ms"][
                 "ssd_chunk_scan_fwd"] for label in ("mamba2", "zamba2")},
         "max_abs_err": errs["ssd_y"], "max_abs_err_state": errs["ssd_state"],
         "ms": t_srv["kernel"], "was_ms": t_srv["was"],
         "plain_ms": t_srv["plain"],
         "bound_ms": t_srv["bound"], "bound_by": t_srv["bound_by"],
         "bound_ms_cuda_cores": t_srv["bound_cuda_cores"],
         "bound_by_cuda_cores": t_srv["bound_by_cuda_cores"],
         "library_ms": None, "tensor_cores": True, "products": "3xTF32",
         "library_note": "no single PyTorch call computes the SSD chunk scan",
         "checks_passed": n_checks["ssd_chunk_scan"],
         "shape": list(t_srv["shape"]), "dtype": "float32",
         "bound_flops": t_srv["needed"], "formula_flops": t_srv["flops"],
         "device_ms_per_kernel": t_srv["parts"],
         "train_shape": list(t_hyb["shape"]), "train_ms": t_hyb["kernel"],
         "train_was_ms": t_hyb["was"], "train_plain_ms": t_hyb["plain"],
         "train_bound_ms": t_hyb["bound"],
         "train_bound_ms_cuda_cores": t_hyb["bound_cuda_cores"],
         "train_device_ms_per_kernel": t_hyb["parts"],
         "launcher_train_shape": list(t_lt["shape"]),
         "launcher_train_ms": t_lt["kernel"],
         "launcher_train_was_ms": t_lt["was"],
         "was_source": "src/repro_torch/csrc/baseline/ssd_mma_sync.cu",
         "launcher_train_plain_ms": t_lt["plain"],
         "launcher_train_bound_ms": t_lt["bound"],
         "serving_prefill_ms": serving["prefill_ms"],
         "serving_decode_ms_per_step": serving["decode_ms"],
         "served": {label: {k: v for k, v in run.items()
                            if k != "launches"}
                    for label, run in served_models.items()
                    if label != "continue"},
         "zamba2_step_ms": {f"use_flash={k[0]} tile=({k[1]}, {k[2]})": ms
                            for k, ms in hyb["step_ms"].items()},
         "zamba2_step_eager_vs_captured": hyb["compare"],
         "zamba2_step_trace": {"wall_ms": trace["wall_ms"],
                               "device_busy_ms": trace["busy_ms"],
                               "device_ms": trace["parts"]},
         "training": {
             "arch": TRAIN_LAUNCH["arch"],
             "adamw_card_vs_host": training["adamw_check"],
             "loss_drop": training["launcher"]["loss_drop"],
             "resume_rel": training["launcher"]["resume_rel"],
             "checkpoint_gib": training["launcher"]["ckpt_gib"],
             "captured_vs_eager_loss": training["launcher"]["eager_gap"],
             "eager_vs_eager_loss": training["launcher"]["eager_spread"],
             "runs": {label: {"steps": run["steps"],
                              "step_ms": run["step_ms"],
                              "update_ms": run["update_ms_mean"],
                              "grad_norm_last": run["grad_norm"][-1],
                              "loss_first": run["result"]["losses"][0],
                              "loss_last": run["result"]["losses"][-1],
                              "peak_gib": run["peak_gib"],
                              "ssd_per_step": run["ssd_per_step"],
                              "eager": run["eager"],
                              "wall_s": run["wall_s"]}
                      for label, run in launcher_runs.items()}}},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
