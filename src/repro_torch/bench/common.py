"""The paper's benchmark objectives on a PyTorch device: DGEMM, TRIAD and
the tiled-GEMM tile search.

Each benchmark binds a configuration to an *invocation factory* (the
evaluator's outer loop): the factory allocates fresh operands from a
seeded numpy generator, resolves the kernel through the shared
:class:`~repro_torch.core.exec_cache.ExecutableCache`, pre-heats it with
one untimed call, and returns a sampler whose observations are GFLOP/s
(DGEMM, tiled GEMM) or GB/s (TRIAD). Work terms, seeds and operand
generation follow ``benchmarks/common.py`` of the JAX package exactly, so
the two packages measure the same configurations on the same data.

  * ``dgemm`` — the paper's vendor DGEMM: ``torch.matmul`` in full f32
    (TF32 off), as the JAX package leaves it to XLA's ``jnp.dot``.
  * ``triad`` — STREAM TRIAD through the hand-written TRIAD kernel.
  * ``gemm_tiled`` — the hand-written GEMM at one target shape; the
    (bm, bn, bk) tile is the tunable and the score is measured GFLOP/s
    (the JAX package tunes the same tiles against a cost model).
  * ``synthetic`` — an instant quadratic objective for session mechanics.
  * ``model_step_family`` — a whole-model step (the train step's loss
    and gradients, or a prefill or decode step where the family has one)
    as an objective over the flash-attention tiles
    (:func:`model_step_space`); GFLOP/s over one shared work term.

``dgemm_benchmark(device)`` and its siblings return the benchmark
callable bound to one device, with a ``precompile`` hook for the tuner's
background pipeline; every one runs on ``cuda`` unless built with
``device="cpu"``.
"""

from __future__ import annotations

import functools
import itertools
import threading
from typing import Callable, Union

import numpy as np
import torch

from ..core import (Direction, EvaluationSettings, SearchSpace,
                    default_cache, grid, timed_sampler)
from ..core.exec_cache import TensorSpec
from ..core.profiling import trace_instant
from ..core.searchspace import doubling_from, powers_of_two
from ..device import resolve_device, synchronizer
from ..kernels import build
from ..kernels.matmul import matmul, smem_bytes
from ..kernels.matmul import TILES as GEMM_TILES
from ..kernels.triad import triad
from ..models.config import ModelConfig
from ..models.transformer import StepConfig
from ..models.workloads import ModelWorkload, build_workload, workload_flops

__all__ = ["GEMM_TILED_SHAPE", "SM90_SMEM_OPTIN_BYTES", "dgemm_benchmark",
           "dgemm_data", "dgemm_flops", "dgemm_space", "emit",
           "gemm_tiled_benchmark", "gemm_tiled_space", "model_step_family",
           "model_step_space", "paper_settings", "print_table",
           "synthetic_benchmark", "triad_benchmark", "triad_data",
           "triad_length", "triad_moved_bytes", "triad_sizes"]


def emit(name: str, us_per_call: float, derived: str) -> None:
    """One ``name,us_per_call,derived`` CSV row (the harness contract)."""
    print(f"{name},{us_per_call:.3f},{derived}")


def print_table(title: str, rows: list[dict]) -> None:
    print(f"\n## {title}")
    if not rows:
        print("(empty)")
        return
    keys = list(rows[0].keys())
    print(" | ".join(f"{k:>14s}" for k in keys))
    for r in rows:
        print(" | ".join(f"{str(r.get(k, '')):>14s}" for k in keys))


# ---------------------------------------------------------------------------
# Work terms and operands
# ---------------------------------------------------------------------------


def dgemm_flops(n: int, m: int, k: int) -> float:
    """Raw FLOPs of one (n,k)x(k,m) matmul — the DGEMM work term."""
    return 2.0 * n * m * k


def triad_length(n_bytes: int, dtype: torch.dtype = torch.float32) -> int:
    """Vector length for a TRIAD working set of ~n_bytes (three arrays)."""
    return max(1024, n_bytes // (3 * dtype.itemsize))


def triad_moved_bytes(n_bytes: int,
                      dtype: torch.dtype = torch.float32) -> float:
    """Raw bytes moved per TRIAD call (read A, read B, write C)."""
    return 3.0 * triad_length(n_bytes, dtype) * dtype.itemsize


def dgemm_seed(n: int, m: int, k: int, invocation: int) -> int:
    """Per-invocation data seed: deterministic across reruns, varying
    between invocations (the JAX package's formula)."""
    return (n * 1_000_003 + m * 10_007 + k * 101 + invocation) % (2 ** 31)


def dgemm_data(n: int, m: int, k: int, seed: int,
               dtype: torch.dtype = torch.float32,
               device: "str | torch.device" = "cuda",
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded (n, k) and (k, m) operands: numpy normals (drawn in float64,
    cast to float32 — bit-identical to the JAX package's), moved to the
    device and cast to ``dtype`` there."""
    rng = np.random.default_rng(seed)
    a = np.asarray(rng.standard_normal((n, k)), dtype=np.float32)
    b = np.asarray(rng.standard_normal((k, m)), dtype=np.float32)
    dev = resolve_device(device)
    return (torch.from_numpy(a).to(dev).to(dtype),
            torch.from_numpy(b).to(dev).to(dtype))


def triad_data(n: int, dtype: torch.dtype = torch.float32,
               device: "str | torch.device" = "cuda",
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded TRIAD vectors of length n from ``default_rng(n % 2**31)``."""
    rng = np.random.default_rng(n % (2 ** 31))
    a = rng.standard_normal(n, dtype=np.float32)
    b = rng.standard_normal(n, dtype=np.float32)
    dev = resolve_device(device)
    return (torch.from_numpy(a).to(dev).to(dtype),
            torch.from_numpy(b).to(dev).to(dtype))


# ---------------------------------------------------------------------------
# Invocation factories
# ---------------------------------------------------------------------------


def dgemm_invocation_factory(n: int, m: int, k: int,
                             dtype: torch.dtype = torch.float32, *,
                             device: "str | torch.device" = "cuda",
                             exec_cache=None) -> Callable:
    """One 'program invocation' of the DGEMM benchmark: allocate fresh
    matrices, pre-heat the product (the paper pre-heats with one untimed
    call), return a GFLOP/s sampler.

    The product is ``torch.matmul`` in full float32: this sets
    ``torch.backends.cuda.matmul.allow_tf32 = False`` for the process,
    because the paper's reference is a full-precision DGEMM and TF32
    would silently trade digits for speed."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    flops = dgemm_flops(n, m, k)
    invocation = itertools.count()
    cache = exec_cache if exec_cache is not None else default_cache()
    sync = synchronizer(dev)

    def factory():
        a, b = dgemm_data(n, m, k, dgemm_seed(n, m, k, next(invocation)),
                          dtype, dev)
        f = cache.compile(torch.matmul, (a, b))
        f(a, b)                              # pre-heat
        sync()
        trace_instant("workload", kernel="dgemm", n=n, m=m, k=k,
                      flops=flops, dtype=str(dtype))

        def run():
            f(a, b)
            sync()

        return timed_sampler(run, work=flops / 1e9)  # GFLOP/s

    return factory


def triad_invocation_factory(n_bytes: int,
                             dtype: torch.dtype = torch.float32, *,
                             device: "str | torch.device" = "cuda",
                             exec_cache=None) -> Callable:
    """TRIAD C = A + 3B over vectors totalling ~n_bytes working set,
    through the hand-written TRIAD kernel; a GB/s sampler."""
    dev = resolve_device(device)
    n = triad_length(n_bytes, dtype)
    moved = triad_moved_bytes(n_bytes, dtype)
    cache = exec_cache if exec_cache is not None else default_cache()
    sync = synchronizer(dev)

    def factory():
        a, b = triad_data(n, dtype, dev)
        f = cache.compile(triad, (a, b), static={"gamma": 3.0})
        f(a, b)                              # pre-heat
        sync()
        trace_instant("workload", kernel="triad", n=n, bytes=moved,
                      dtype=str(dtype))

        def run():
            f(a, b)
            sync()

        return timed_sampler(run, work=moved / 1e9)  # GB/s

    return factory


def gemm_tiled_invocation_factory(bm: int, bn: int, bk: int,
                                  data: Callable[[], tuple],
                                  *, device: "str | torch.device" = "cuda",
                                  exec_cache=None) -> Callable:
    """The hand-written GEMM at one (bm, bn, bk) tile; a GFLOP/s
    sampler. ``data`` supplies the (m, k) and (k, n) operands, shared
    across tiles and invocations: GEMM's runtime is data-oblivious, and
    redrawing ~38 M normals per invocation would dominate the search."""
    dev = resolve_device(device)
    cache = exec_cache if exec_cache is not None else default_cache()
    sync = synchronizer(dev)

    def factory():
        a, b = data()
        (m, k), n = a.shape, b.shape[1]
        flops = dgemm_flops(m, n, k)
        f = cache.compile(matmul, (a, b), static={"bm": bm, "bn": bn,
                                                  "bk": bk})
        f(a, b)                              # pre-heat
        sync()
        trace_instant("workload", kernel="gemm_tiled", m=m, n=n, k=k,
                      bm=bm, bn=bn, bk=bk, flops=flops, dtype=str(a.dtype))

        def run():
            f(a, b)
            sync()

        return timed_sampler(run, work=flops / 1e9)  # GFLOP/s

    return factory


# ---------------------------------------------------------------------------
# Spaces and settings
# ---------------------------------------------------------------------------


def dgemm_space(quick: bool = True) -> SearchSpace:
    """The paper's reduced DGEMM space (Sec. IV-A): leading dims as
    multiples of 2 (500-doubling ladder) plus powers of 2; ``quick``
    keeps the small corner."""
    if quick:
        return grid(n=(256, 512, 1024), m=(256, 512, 1024),
                    k=(64, 128, 256, 512))
    return grid(n=doubling_from(500, 4000) + powers_of_two(512, 2048),
                m=doubling_from(500, 4000) + powers_of_two(512, 2048),
                k=powers_of_two(64, 2048))


def triad_sizes(quick: bool = True) -> tuple[int, ...]:
    """TRIAD working-set sizes in bytes: 64 KiB..16 MiB quick, or the
    16 KiB..64 MiB ladder that crosses every cache level."""
    return (2 ** 16, 2 ** 20, 2 ** 24) if quick else \
        tuple(2 ** e for e in range(14, 28, 2))


def paper_settings(quick: bool = True) -> EvaluationSettings:
    """Table I scaled for CI runtime: same structure, smaller budget."""
    if quick:
        return EvaluationSettings(max_invocations=4, max_iterations=60,
                                  max_time_s=1.5,
                                  direction=Direction.MAXIMIZE)
    return EvaluationSettings(max_invocations=10, max_iterations=200,
                              max_time_s=10.0,
                              direction=Direction.MAXIMIZE)


#: the tile search's target GEMM (the JAX package's ``bench_kernel_autotune``
#: shape: one tensor-parallel shard of a Mixtral expert GEMM), in float32
GEMM_TILED_SHAPE = {"m": 4096, "n": 2048, "k": 6144}
#: shared memory one block may take on an H100 with the opt-in attribute
#: that every launch of the GEMM kernel sets (the card the kernels target)
SM90_SMEM_OPTIN_BYTES = 232448


def block_smem_limit(device: "str | torch.device" = "cuda") -> int:
    """Shared memory one block may use on ``device``: the card's opt-in
    per-block limit (the static 48 KiB is not the limit: the kernels opt
    in), or, for the host's plain path, which has none, the H100's."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return SM90_SMEM_OPTIN_BYTES
    props = torch.cuda.get_device_properties(dev)
    return int(getattr(props, "shared_memory_per_block_optin",
                       props.shared_memory_per_block))


def gemm_tiled_space(
        smem_limit: int = SM90_SMEM_OPTIN_BYTES) -> SearchSpace:
    """(bm, bn, bk) over the kernel's tile table, constrained to tiles
    whose shared memory fits one block (the kernel masks ragged edges,
    so no tile has to divide the problem)."""
    table = set(GEMM_TILES)
    return grid(bm=sorted({t[0] for t in table}),
                bn=sorted({t[1] for t in table}),
                bk=sorted({t[2] for t in table})).constrain(
        lambda c: (c["bm"], c["bn"], c["bk"]) in table,
        lambda c: smem_bytes(c["bm"], c["bn"], c["bk"]) <= smem_limit)


# ---------------------------------------------------------------------------
# Benchmarks (config -> invocation factory), each bound to one device
# ---------------------------------------------------------------------------


def dgemm_benchmark(device: str = "cuda") -> Callable:
    """``dgemm`` on ``device``: config (n, m, k) -> a ``torch.matmul``
    f32 sampler factory, with the compile pipeline's ``precompile``."""

    def bench(cfg: dict) -> Callable:
        return dgemm_invocation_factory(cfg["n"], cfg["m"], cfg["k"],
                                        device=device)

    def precompile(cfg: dict) -> None:
        n, m, k = cfg["n"], cfg["m"], cfg["k"]
        default_cache().compile(
            torch.matmul, (TensorSpec((n, k), torch.float32, device),
                           TensorSpec((k, m), torch.float32, device)))

    bench.precompile = precompile
    return bench


def triad_benchmark(device: str = "cuda") -> Callable:
    """``triad`` on ``device``: config (n_bytes,) -> a TRIAD-kernel GB/s
    sampler factory (float32), with ``precompile``."""

    def bench(cfg: dict) -> Callable:
        return triad_invocation_factory(cfg["n_bytes"], device=device)

    def precompile(cfg: dict) -> None:
        spec = TensorSpec((triad_length(cfg["n_bytes"]),), torch.float32,
                          device)
        default_cache().compile(triad, (spec, spec), static={"gamma": 3.0})

    bench.precompile = precompile
    return bench


def gemm_tiled_benchmark(device: str = "cuda") -> Callable:
    """``gemm_tiled`` on ``device``: config (bm, bn, bk) -> the
    hand-written GEMM's GFLOP/s at :data:`GEMM_TILED_SHAPE` in float32.
    The operands are drawn once, at the first invocation, and shared by
    every tile (GEMM is data-oblivious), so a tile search pays the large
    draw once."""
    m, n, k = (GEMM_TILED_SHAPE[d] for d in "mnk")

    @functools.cache
    def operands() -> tuple[torch.Tensor, torch.Tensor]:
        return dgemm_data(m, n, k, dgemm_seed(m, n, k, 0),
                          device=device)

    def bench(cfg: dict) -> Callable:
        return gemm_tiled_invocation_factory(
            cfg["bm"], cfg["bn"], cfg["bk"], operands, device=device)

    def precompile(cfg: dict) -> None:
        default_cache().compile(
            matmul, (TensorSpec((m, k), torch.float32, device),
                     TensorSpec((k, n), torch.float32, device)),
            static={"bm": cfg["bm"], "bn": cfg["bn"], "bk": cfg["bk"]})

    bench.precompile = precompile
    return bench


# ---------------------------------------------------------------------------
# Whole-model workloads as tuning objectives
# ---------------------------------------------------------------------------
#
# A model step is a benchmark like any other: the config carries the
# StepConfig execution knobs (flash-attention tiles, remat), the score is
# GFLOP/s over one work term per model (FlopCounterMode on the plain
# path, see repro_torch.models.workloads), so the ranking is by time.


def model_step_space(quick: bool = True) -> SearchSpace:
    """Execution-knob space of a whole-model step. ``use_flash`` gates
    the flash kernel; the tiles only bind when it is on — kept in one
    grid so the tuner sees the interaction."""
    if quick:
        return grid(use_flash=(0, 1), flash_block_q=(64, 128),
                    flash_block_k=(64, 128))
    return grid(use_flash=(0, 1), flash_block_q=(64, 128, 256, 512),
                flash_block_k=(64, 128, 256, 512), remat=(0, 1))


def _model_step(base: ModelWorkload, cfg: dict) -> ModelWorkload:
    """The family's workload under one tuner config: the same weights and
    tokens, the config's execution knobs."""
    return base.with_step(StepConfig(
        use_flash=bool(cfg.get("use_flash", 0)),
        flash_block_q=int(cfg.get("flash_block_q", 512)),
        flash_block_k=int(cfg.get("flash_block_k", 512)),
        remat=bool(cfg.get("remat", 0))))


def model_step_family(workload: str,
                      arch: Union[str, ModelConfig, None] = None, *,
                      batch_size: int = 2, seq_len: int = 64,
                      device: "str | torch.device" = "cuda") -> Callable:
    """Benchmark family for one whole-model step on ``device``.

    ``workload`` names a :mod:`repro_torch.models.workloads` builder
    (``train_step``; ``prefill_step`` for the ``ssm`` and ``hybrid``
    families, ``decode_step`` for ``ssm``); ``arch`` is an architecture
    name (its SMOKE config), a :class:`ModelConfig` or None (the tiny
    dense toy). The weights, inputs and work term are built once, at the
    first config, and shared by every config; each config pre-heats
    once, at its first invocation. Samples are host-clock GFLOP/s around
    one step and a ``torch.cuda.synchronize``: a step takes
    milliseconds, so the tens of microseconds of dispatch and
    synchronize in each sample (PERF.md) are negligible. ``precompile``
    builds the shared workload and, on the card, the kernel library for
    a flash config or a model with SSD layers, in the tuner's background
    pipeline.
    """
    dev = resolve_device(device)
    sync = synchronizer(dev)
    lock = threading.Lock()
    shared: dict = {}

    def base() -> tuple[ModelWorkload, float]:
        with lock:
            if not shared:
                w = build_workload(workload, arch, batch_size=batch_size,
                                   seq_len=seq_len, device=dev)
                shared.update(workload=w, flops=workload_flops(w))
            return shared["workload"], shared["flops"]

    def bench(cfg: dict) -> Callable:
        w, flops = base()
        wc = _model_step(w, cfg)
        heated = threading.Event()

        def factory():
            if not heated.is_set():
                wc.fn(*wc.args)                  # pre-heat, once per config
                sync()
                heated.set()
            trace_instant("workload", kernel=workload, arch=w.cfg.name,
                          flops=flops, **{k: cfg[k] for k in sorted(cfg)})

            def run():
                wc.fn(*wc.args)
                sync()

            return timed_sampler(run, work=flops / 1e9)  # GFLOP/s

        return factory

    def precompile(cfg: dict) -> None:
        w, _ = base()
        if dev.type == "cuda" and (cfg.get("use_flash") or w.cfg.family in
                                   ("ssm", "hybrid")):
            build.library()

    bench.precompile = precompile
    bench.__name__ = f"model_step_{workload}"
    return bench


def synthetic_benchmark(cfg: dict) -> Callable:
    """Instant quadratic objective (optimum x=7, score 100) for
    smoke-testing session mechanics without timing noise."""
    mu = 100.0 - (cfg["x"] - 7) ** 2

    def factory():
        return lambda: mu

    return factory
