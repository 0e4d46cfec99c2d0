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
  * the shape-sweep families (:mod:`repro_torch.sweep`):
    ``synthetic_gemm_family``, an instant shape-conditioned objective,
    and ``chunked_dgemm_family``, a measured f32 product with K split
    into ``k_chunk``-wide chunks (``torch.einsum``, TF32 off), over the
    shape grid :func:`gemm_shape_space`.
  * ``model_step_family`` — a whole-model step (the train step's loss
    and gradients, or a prefill or decode step)
    as an objective over the flash-attention tiles
    (:func:`model_step_space`); GFLOP/s over one shared work term.

``dgemm_benchmark(device)`` and its siblings return the benchmark bound
to one device: a small module-level class holding the device name, so it
pickles into ``ProcessPoolBackend`` workers, with a ``precompile`` hook
for the tuner's background pipeline (``dgemm_precompile``,
``triad_precompile``) and an ``audit_spec`` for the workload audit
(:mod:`repro_torch.lint`: the kernel it times on ``meta`` operands and
the work term it divides by, from the same helper); every one runs on
``cuda`` unless built with ``device="cpu"``. :func:`audited_workloads`
is the audit's registry.

The paper-table benches tune DGEMM over :func:`paper_dgemm_space`. On
the host, and in every parity test, its quick space is the JAX
package's ``dgemm_space(True)`` (n, m <= 1024, k <= 512), which that
package scales to its host. On a card those products take tens of
microseconds, which the host clock around launch + synchronize cannot
tell from the dispatch, so a quick run on ``cuda`` takes
:func:`card_dgemm_space` instead: the full space's own values n, m in
{2000, 4000} and k in {1024, 2048}, 8 configs of 8.2-65.5 GFLOP (the
roofline-model bench departs from the quick corner on a card for the
same reason).
"""

from __future__ import annotations

import functools
import itertools
import math
import threading
from typing import Callable, Union

import numpy as np
import torch

from ..core import (Direction, EvaluationSettings, SearchSpace,
                    default_cache, grid, steady_sampler, timed_sampler)
from ..core.card_clock import CardClock
from ..core.exec_cache import TensorSpec
from ..core.profiling import trace_instant
from ..core.searchspace import doubling_from, powers_of_two
from ..device import resolve_device, synchronizer
from ..kernels import build
from ..kernels.matmul import matmul, smem_bytes
from ..kernels.matmul import TILES as GEMM_TILES
from ..kernels.triad import triad
from ..lint.workload import WorkloadSpec
from ..models.config import ModelConfig
from ..models.transformer import StepConfig
from ..models.workloads import (ModelWorkload, build_workload, meta_step,
                                resolve_arch, step_flops, workload_flops)

__all__ = ["AUDITED_WORKLOADS", "CSV_ROWS", "DgemmBenchmark",
           "GEMM_TILED_SHAPE", "GemmTiledBenchmark", "SM90_SMEM_OPTIN_BYTES",
           "SWEEP_TILES", "TriadBenchmark", "audited_workloads", "bench_main",
           "card_dgemm_space", "chunked_dgemm_data", "chunked_dgemm_family",
           "chunked_dgemm_kernel", "dgemm_audit_spec", "dgemm_benchmark",
           "dgemm_data", "dgemm_flops", "dgemm_precompile", "dgemm_space",
           "emit", "gemm_shape_space", "gemm_tiled_audit_spec",
           "gemm_tiled_benchmark", "gemm_tiled_space", "model_step_family",
           "model_step_space", "paper_dgemm_space", "paper_settings",
           "print_table", "sweep_chunk_space", "sweep_config_space",
           "synthetic_benchmark", "synthetic_gemm_family", "triad_audit_spec",
           "triad_benchmark", "triad_data", "triad_length",
           "triad_moved_bytes", "triad_precompile", "triad_sizes", "where"]

#: every row :func:`emit` printed in this process, in order
CSV_ROWS: list[tuple[str, float, str]] = []


def emit(name: str, us_per_call: float, derived: str) -> None:
    """One ``name,us_per_call,derived`` CSV row (the harness contract)."""
    CSV_ROWS.append((name, us_per_call, derived))
    print(f"{name},{us_per_call:.3f},{derived}")


def where(device: str) -> str:
    """The table titles' name for the measured machine."""
    return "this card" if device == "cuda" else "this host"


def bench_main(run: Callable, doc: str, argv=None) -> int:
    """``python -m repro_torch.bench.<table> [--full] [--device cpu]``:
    one paper-table bench on its own."""
    import argparse
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--full", action="store_true",
                    help="paper Table I budgets (slow)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    run(quick=not args.full, device=args.device)
    return 0


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
                             exec_cache=None, sampler: str = "timed",
                             batch=None, reuse_data: bool = False,
                             ) -> Callable:
    """One 'program invocation' of the DGEMM benchmark: allocate fresh
    matrices, pre-heat the product (the paper pre-heats with one untimed
    call), return a GFLOP/s sampler.

    The product is ``torch.matmul`` in full float32: this sets
    ``torch.backends.cuda.matmul.allow_tf32 = False`` for the process,
    because the paper's reference is a full-precision DGEMM and TF32
    would silently trade digits for speed.

    ``sampler="steady"`` returns a batched
    :func:`~repro_torch.core.evaluator.steady_sampler` (B launches, one
    ``torch.cuda.synchronize`` per observation); the auto-calibrated B
    is cached across invocations, so calibration runs once per config.
    ``reuse_data=True`` draws the operands once per *config* instead of
    once per invocation — sound for GEMM on normal data, whose runtime
    is data-oblivious, and it removes the dominant setup cost of short
    trials.

    On a card both samplers time on the card's clock (one
    :class:`~repro_torch.core.card_clock.CardClock` per config, shared by
    its invocations): the product's launch and the synchronize's return,
    tens of microseconds a sample on the host clock, stay out of the
    score. On the host the samplers keep the host clock."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    flops = dgemm_flops(n, m, k)
    invocation = itertools.count()
    cache = exec_cache if exec_cache is not None else default_cache()
    sync = synchronizer(dev)
    card = CardClock() if dev.type == "cuda" else None
    state = {"batch": batch, "data": None}

    def factory():
        seed = dgemm_seed(n, m, k, next(invocation))
        if reuse_data and state["data"] is not None:
            a, b = state["data"]
        else:
            a, b = dgemm_data(n, m, k, seed, dtype, dev)
            if reuse_data:
                state["data"] = (a, b)
        f = cache.compile(torch.matmul, (a, b))
        f(a, b)                              # pre-heat
        sync()
        trace_instant("workload", kernel="dgemm", n=n, m=m, k=k,
                      flops=flops, dtype=str(dtype))
        if sampler == "steady":
            s = steady_sampler(lambda: f(a, b), work=flops / 1e9,
                               sync=sync, batch=state["batch"],
                               card_clock=card)
            state["batch"] = s.batch         # calibrate once per config
            return s
        if card is not None:
            return timed_sampler(lambda: f(a, b), work=flops / 1e9,
                                 card_clock=card)

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
    redrawing ~38 M normals per invocation would dominate the search. On
    a card the sampler times on the card's clock (one
    :class:`~repro_torch.core.card_clock.CardClock` per tile), as the
    DGEMM samplers do: the launch and the synchronize's return, which
    grow with the host's other work, stay out of the score."""
    dev = resolve_device(device)
    cache = exec_cache if exec_cache is not None else default_cache()
    sync = synchronizer(dev)
    card = CardClock() if dev.type == "cuda" else None

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
        if card is not None:
            return timed_sampler(lambda: f(a, b), work=flops / 1e9,
                                 card_clock=card)

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


def card_dgemm_space() -> SearchSpace:
    """The quick paper benches' DGEMM space on a card: the full space's
    own values n, m in {2000, 4000}, k in {1024, 2048} (8 configs of
    8.2-65.5 GFLOP; see the module docstring)."""
    return grid(n=(2000, 4000), m=(2000, 4000), k=(1024, 2048))


def paper_dgemm_space(quick: bool = True,
                      device: "str | torch.device" = "cuda") -> SearchSpace:
    """The DGEMM space the paper benches and the CLI tune on ``device``:
    :func:`card_dgemm_space` for a quick run on ``cuda``, otherwise
    :func:`dgemm_space`."""
    if quick and resolve_device(device).type == "cuda":
        return card_dgemm_space()
    return dgemm_space(quick)


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
#
# Module-level classes holding the device name (not closures), so they
# pickle into ProcessPoolBackend workers.


def _meta(shape: tuple, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """An audit spec's operand: shape and dtype only, nothing allocated
    (the counterpart of ``jax.ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def dgemm_audit_spec(cfg: dict) -> WorkloadSpec:
    """The DGEMM benchmark's declaration for the workload audit: the
    ``torch.matmul`` it times and the :func:`dgemm_flops` it divides by."""
    n, m, k = cfg["n"], cfg["m"], cfg["k"]
    return WorkloadSpec(
        fn=torch.matmul, args=(_meta((n, k)), _meta((k, m))),
        work=dgemm_flops(n, m, k), unit="flops", dtype="float32",
        name=f"dgemm[{n}x{m}x{k}]")


def triad_audit_spec(cfg: dict) -> WorkloadSpec:
    """The TRIAD benchmark's declaration: ``repro_torch::triad`` (the hand
    kernel the benchmark times) and :func:`triad_moved_bytes`."""
    n_bytes = cfg["n_bytes"]
    n = triad_length(n_bytes)
    return WorkloadSpec(
        fn=functools.partial(triad, gamma=3.0),
        args=(_meta((n,)), _meta((n,))),
        work=triad_moved_bytes(n_bytes), unit="bytes", dtype="float32",
        name=f"triad[{n_bytes}B]")


def gemm_tiled_audit_spec(cfg: dict) -> WorkloadSpec:
    """The tile search's declaration: ``repro_torch::matmul`` at the
    config's tile over :data:`GEMM_TILED_SHAPE` and :func:`dgemm_flops`."""
    m, n, k = (GEMM_TILED_SHAPE[d] for d in "mnk")
    return WorkloadSpec(
        fn=functools.partial(matmul, bm=cfg["bm"], bn=cfg["bn"],
                             bk=cfg["bk"]),
        args=(_meta((m, k)), _meta((k, n))),
        work=dgemm_flops(m, n, k), unit="flops", dtype="float32",
        name=f"gemm_tiled[{m}x{n}x{k}/{cfg['bm']}x{cfg['bn']}x{cfg['bk']}]")


def dgemm_precompile(cfg: dict, device: "str | torch.device" = "cuda",
                     ) -> None:
    """Resolve the executable cache's entry for one DGEMM config from
    tensor specs — nothing is allocated or executed."""
    n, m, k = cfg["n"], cfg["m"], cfg["k"]
    default_cache().compile(
        torch.matmul, (TensorSpec((n, k), torch.float32, device),
                       TensorSpec((k, m), torch.float32, device)))


def triad_precompile(cfg: dict, device: "str | torch.device" = "cuda",
                     ) -> None:
    """Resolve the TRIAD kernel for one working set from tensor specs
    (on a card this builds the kernel library on its first call)."""
    spec = TensorSpec((triad_length(cfg["n_bytes"]),), torch.float32,
                      device)
    default_cache().compile(triad, (spec, spec), static={"gamma": 3.0})


class DgemmBenchmark:
    """``dgemm`` on one device: config (n, m, k) -> a ``torch.matmul``
    f32 sampler factory (:func:`dgemm_invocation_factory` with this
    benchmark's ``sampler``, ``batch`` and ``reuse_data``)."""

    def __init__(self, device: str = "cuda", *, sampler: str = "timed",
                 batch=None, reuse_data: bool = False):
        self.device = device
        self.sampler = sampler
        self.batch = batch
        self.reuse_data = reuse_data

    def __call__(self, cfg: dict) -> Callable:
        return dgemm_invocation_factory(
            cfg["n"], cfg["m"], cfg["k"], device=self.device,
            sampler=self.sampler, batch=self.batch,
            reuse_data=self.reuse_data)

    def precompile(self, cfg: dict) -> None:
        dgemm_precompile(cfg, self.device)

    audit_spec = staticmethod(dgemm_audit_spec)


class TriadBenchmark:
    """``triad`` on one device: config (n_bytes,) -> a TRIAD-kernel GB/s
    sampler factory (float32)."""

    def __init__(self, device: str = "cuda"):
        self.device = device

    def __call__(self, cfg: dict) -> Callable:
        return triad_invocation_factory(cfg["n_bytes"], device=self.device)

    def precompile(self, cfg: dict) -> None:
        triad_precompile(cfg, self.device)

    audit_spec = staticmethod(triad_audit_spec)


class GemmTiledBenchmark:
    """``gemm_tiled`` on one device: config (bm, bn, bk) -> the
    hand-written GEMM's GFLOP/s at :data:`GEMM_TILED_SHAPE` in float32.
    The operands are drawn once, at the first invocation, and shared by
    every tile (GEMM is data-oblivious), so a tile search pays the large
    draw once; a pickled copy draws its own."""

    def __init__(self, device: str = "cuda"):
        self.device = device
        self._operands = None
        self._lock = threading.Lock()

    def __getstate__(self) -> dict:
        return {"device": self.device}

    def __setstate__(self, state: dict) -> None:
        self.__init__(state["device"])

    def operands(self) -> tuple[torch.Tensor, torch.Tensor]:
        with self._lock:
            if self._operands is None:
                m, n, k = (GEMM_TILED_SHAPE[d] for d in "mnk")
                self._operands = dgemm_data(m, n, k, dgemm_seed(m, n, k, 0),
                                            device=self.device)
            return self._operands

    def __call__(self, cfg: dict) -> Callable:
        return gemm_tiled_invocation_factory(
            cfg["bm"], cfg["bn"], cfg["bk"], self.operands,
            device=self.device)

    def precompile(self, cfg: dict) -> None:
        m, n, k = (GEMM_TILED_SHAPE[d] for d in "mnk")
        default_cache().compile(
            matmul, (TensorSpec((m, k), torch.float32, self.device),
                     TensorSpec((k, n), torch.float32, self.device)),
            static={"bm": cfg["bm"], "bn": cfg["bn"], "bk": cfg["bk"]})

    audit_spec = staticmethod(gemm_tiled_audit_spec)


def dgemm_benchmark(device: str = "cuda", **kwargs) -> DgemmBenchmark:
    """``dgemm`` on ``device`` (keywords: ``sampler``, ``batch``,
    ``reuse_data``; see :class:`DgemmBenchmark`)."""
    return DgemmBenchmark(device, **kwargs)


def triad_benchmark(device: str = "cuda") -> TriadBenchmark:
    """``triad`` on ``device`` (see :class:`TriadBenchmark`)."""
    return TriadBenchmark(device)


def gemm_tiled_benchmark(device: str = "cuda") -> GemmTiledBenchmark:
    """``gemm_tiled`` on ``device`` (see :class:`GemmTiledBenchmark`)."""
    return GemmTiledBenchmark(device)


# ---------------------------------------------------------------------------
# Shape-sweep families (repro_torch.sweep): shape -> benchmark factory
# ---------------------------------------------------------------------------
#
# A *family* specializes the objective to one problem shape; the sweep
# campaign calls it once per grid point. Family closures capture the shape
# (not picklable) — drive campaigns with the serial or thread backend.

#: shared tile ladder of the sweep config space (powers of two, so every
#: k_chunk divides every power-of-two K)
SWEEP_TILES = (16, 32, 64, 128, 256, 512)


def gemm_shape_space(quick: bool = True) -> SearchSpace:
    """The (M, N[, K]) shape grid a sweep campaign tunes: a 3×3 grid of
    the paper's host-scaled DGEMM dims for CI, the full power-of-two
    ladder (with K) otherwise."""
    if quick:
        return grid(m=(256, 512, 1024), n=(256, 512, 1024))
    return grid(m=powers_of_two(256, 4096), n=powers_of_two(256, 4096),
                k=powers_of_two(64, 1024))


def sweep_config_space() -> SearchSpace:
    """Per-shape tunables shared by the sweep families."""
    return grid(bm=SWEEP_TILES, bn=SWEEP_TILES)


def synthetic_gemm_family(shape: dict) -> Callable:
    """Instant shape-conditioned objective for sweep mechanics tests.

    The optimal (bm, bn) tile *level* moves linearly with the shape's
    position on the (log-scale) 256..1024 ladder, and the score is
    quadratic around it — so in the joint encoder's features (config
    level index × log-normalized shape coordinate, both linear) the whole
    surface is exactly degree-2. The ridge surrogate can therefore
    represent it exactly, which makes oracle-interpolation acceptance
    tests sharp: any gap to the true optimum is a harness bug, not model
    bias. Peak score is 100 when the ideal tile lands on a ladder level.
    """
    levels = {v: i for i, v in enumerate(SWEEP_TILES)}
    top = len(SWEEP_TILES) - 1

    def ideal(dim_value: float, lo: float = 256.0, hi: float = 1024.0):
        t = (math.log(dim_value) - math.log(lo)) / (math.log(hi)
                                                    - math.log(lo))
        return top * min(max(t, 0.0), 1.0)

    ia, ib = ideal(shape["m"]), ideal(shape.get("n", shape["m"]))

    def bench(cfg: dict) -> Callable:
        mu = (100.0 - (levels[cfg["bm"]] - ia) ** 2
              - 0.5 * (levels[cfg["bn"]] - ib) ** 2)

        def factory():
            return lambda: mu

        return factory

    return bench


def chunked_dgemm_kernel(a3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """DGEMM with the K axis pre-split into (chunks, k_chunk) — one
    einsum contracting both: identical 2·M·N·K flops to ``torch.matmul``,
    different layout (the tunable). A library product, as the JAX
    package's ``jnp.einsum`` is: no Pallas kernel computes it there."""
    return torch.einsum("mck,ckn->mn", a3, b3)


def chunked_dgemm_data(m: int, n: int, k: int, k_chunk: int, seed: int,
                       device: "str | torch.device" = "cuda",
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded (m, k/k_chunk, k_chunk) and (k/k_chunk, k_chunk, n) f32
    operands of :func:`chunked_dgemm_kernel`: numpy normals (drawn in
    float64, cast to float32), moved to the device."""
    chunks = k // k_chunk
    rng = np.random.default_rng(seed)
    a = np.asarray(rng.standard_normal((m, chunks, k_chunk)),
                   dtype=np.float32)
    b = np.asarray(rng.standard_normal((chunks, k_chunk, n)),
                   dtype=np.float32)
    dev = resolve_device(device)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def chunked_dgemm_family(shape: dict,
                         device: "str | torch.device" = "cuda") -> Callable:
    """Real measured DGEMM family on ``device``: C = A·B with A's K axis
    split into ``k_chunk``-wide chunks (snapped down to K when larger).
    Scores are GFLOP/s over the same useful work regardless of chunking,
    so configs compare on time alone.

    The product runs in full float32 (TF32 off for the process, as
    :func:`dgemm_invocation_factory` sets it) on fresh seeded operands
    per invocation (the JAX package's seed formula, numpy's generator),
    and on a card each sample is timed on the card's clock (one
    :class:`~repro_torch.core.card_clock.CardClock` per config, as the
    DGEMM samplers are: the host clock would add the product's launch and
    the synchronize's return to every sample). ``bench.audit_spec``
    declares the einsum on ``meta`` operands and the 2mnk FLOPs the
    samplers divide by; ``bench.precompile`` resolves the einsum in the
    executable cache from tensor specs."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    m, n, k = shape["m"], shape["n"], shape.get("k", 256)
    flops = dgemm_flops(m, n, k)
    cache = default_cache()
    sync = synchronizer(dev)

    def bench(cfg: dict) -> Callable:
        kc = min(cfg["k_chunk"], k)
        invocation = itertools.count()
        card = CardClock() if dev.type == "cuda" else None

        def factory():
            seed = (m * 1_000_003 + n * 10_007 + k * 101 + kc * 13
                    + next(invocation)) % (2 ** 31)
            a, b = chunked_dgemm_data(m, n, k, kc, seed, dev)
            f = cache.compile(chunked_dgemm_kernel, (a, b))
            f(a, b)                              # pre-heat
            sync()
            trace_instant("workload", kernel="dgemm_sweep", m=m, n=n, k=k,
                          k_chunk=kc, flops=flops)
            if card is not None:
                return timed_sampler(lambda: f(a, b), work=flops / 1e9,
                                     card_clock=card)

            def run():
                f(a, b)
                sync()

            return timed_sampler(run, work=flops / 1e9)  # GFLOP/s

        return factory

    def operand_shapes(cfg: dict) -> tuple[tuple, tuple]:
        kc = min(cfg["k_chunk"], k)
        return (m, k // kc, kc), (k // kc, kc, n)

    def sweep_audit_spec(cfg: dict) -> WorkloadSpec:
        sa, sb = operand_shapes(cfg)
        return WorkloadSpec(
            fn=chunked_dgemm_kernel, args=(_meta(sa), _meta(sb)),
            work=flops, unit="flops", dtype="float32",
            name=f"dgemm_sweep[{m}x{n}x{k}/kc{sa[2]}]")

    def sweep_precompile(cfg: dict) -> None:
        sa, sb = operand_shapes(cfg)
        cache.compile(chunked_dgemm_kernel,
                      (TensorSpec(sa, torch.float32, dev),
                       TensorSpec(sb, torch.float32, dev)))

    bench.audit_spec = sweep_audit_spec
    bench.precompile = sweep_precompile
    return bench


def sweep_chunk_space(k_max: int = 512) -> SearchSpace:
    """Config space of :func:`chunked_dgemm_family`."""
    return grid(k_chunk=powers_of_two(16, k_max))


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


def _model_step_config(cfg: dict) -> StepConfig:
    """A tuner config's execution knobs."""
    return StepConfig(
        use_flash=bool(cfg.get("use_flash", 0)),
        flash_block_q=int(cfg.get("flash_block_q", 512)),
        flash_block_k=int(cfg.get("flash_block_k", 512)),
        remat=bool(cfg.get("remat", 0)))


def _model_step(base: ModelWorkload, cfg: dict) -> ModelWorkload:
    """The family's workload under one tuner config: the same weights and
    tokens, the config's execution knobs."""
    return base.with_step(_model_step_config(cfg))


def model_step_family(workload: str,
                      arch: Union[str, ModelConfig, None] = None, *,
                      batch_size: int = 2, seq_len: int = 64,
                      device: "str | torch.device" = "cuda") -> Callable:
    """Benchmark family for one whole-model step on ``device``.

    ``workload`` names a :mod:`repro_torch.models.workloads` builder
    (``train_step``, ``prefill_step`` or ``decode_step``, for every
    family); ``arch`` is an architecture
    name (its SMOKE config), a :class:`ModelConfig` or None (the tiny
    dense toy). The weights, inputs and work term are built once, at the
    first config, and shared by every config; each config pre-heats
    once, at its first invocation. Samples are host-clock GFLOP/s around
    one step and a ``torch.cuda.synchronize``: a step takes
    milliseconds, so the tens of microseconds of dispatch and
    synchronize in each sample (PERF.md) are negligible. ``precompile``
    builds the shared workload and, on the card, the kernel library for
    a flash config or a model with SSD layers, in the tuner's background
    pipeline. ``audit_spec`` declares the step under a config on ``meta``
    weights and tokens against the family's work term (the plain path's
    count): the tuner audits the space's first config, ``use_flash=0``,
    where the two agree; at ``use_flash=1`` the trace counts the flash
    op's causal work, about half the plain path's masked products.
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

    def audit_spec(cfg: dict) -> WorkloadSpec:
        # the step under this config on meta weights and tokens, against
        # the family's work term (the plain path's count, workload_flops)
        mcfg = resolve_arch(arch)
        kind = workload[:-len("_step")]
        step = _model_step_config(cfg)
        fn, args = meta_step(mcfg, batch_size, seq_len, kind, step)
        return WorkloadSpec(
            fn=fn, args=args,
            work=step_flops(mcfg, batch_size, seq_len, kind), unit="flops",
            name=f"{workload}[{mcfg.name} b{batch_size} s{seq_len}]")

    bench.precompile = precompile
    bench.audit_spec = audit_spec
    bench.__name__ = f"model_step_{workload}"
    return bench


def synthetic_benchmark(cfg: dict) -> Callable:
    """Instant quadratic objective (optimum x=7, score 100) for
    smoke-testing session mechanics without timing noise."""
    mu = 100.0 - (cfg["x"] - 7) ** 2

    def factory():
        return lambda: mu

    return factory


# ---------------------------------------------------------------------------
# The workload audit's registry (repro_torch.lint pass 1)
# ---------------------------------------------------------------------------


def audited_workloads(device: "str | torch.device" = "cuda",
                      ) -> dict[str, tuple[Callable, dict]]:
    """The benchmarks ``python -m repro_torch.lint`` audits, bound to
    ``device``, with a sample config each (the JAX package's registry).
    Every spec traces on ``meta``."""
    return {
        "dgemm": (dgemm_benchmark(device), {"n": 256, "m": 256, "k": 64}),
        "triad": (triad_benchmark(device), {"n_bytes": 1 << 20}),
        "synthetic": (synthetic_benchmark, {"x": 7}),
        # one representative shape of the sweep family: the audit traces
        # the chunked product and must see exactly the 2mnk flops it
        # declares
        "dgemm_sweep": (chunked_dgemm_family({"m": 256, "n": 256, "k": 256},
                                             device), {"k_chunk": 64}),
        # whole-model step: the work term is FlopCounterMode's count of
        # the plain path, the trace the dispatcher's, so the audit checks
        # the GFLOP/s conversion against the step the tuner times
        "train_step": (model_step_family("train_step", device=device),
                       {"use_flash": 0, "flash_block_q": 64,
                        "flash_block_k": 64}),
        "decode_step": (model_step_family("decode_step", device=device),
                        {"use_flash": 0, "flash_block_q": 64,
                         "flash_block_k": 64}),
    }


#: the registry bound to the host (``audited_workloads("cpu")``)
AUDITED_WORKLOADS = audited_workloads("cpu")
