"""Pass 1 — workload audit: is the benchmark measuring what it claims?

The evaluator converts time into GFLOP/s (or GB/s) by dividing a
*declared* work term by the measured duration
(:func:`repro_torch.core.evaluator.timed_sampler`). Every roofline
placement downstream inherits that constant, so a wrong declaration
poisons the whole analysis while every CI happily converges — the
paper's <2% error budget assumes the work term is right. This pass
traces the benchmark's kernel and cross-checks:

  MS101  declared work vs traced cost beyond tolerance
  MS102  traced computation is dead or constant (the timed call
         dispatches no work, so the score is fantasy throughput)
  MS103  traced dtype differs from the declared one (a float32 product
         declared as a float64 DGEMM: check the operand dtypes)

Benchmarks opt in by exposing an ``audit_spec`` attribute: a callable
``config -> WorkloadSpec`` naming the torch function, example arguments
(tensors on the ``meta`` device avoid allocation), and the declared work
in raw FLOPs/bytes — computed by the *same helper* the invocation
factory uses, so the audit checks the shared formula against reality.
The trace is one call under
:class:`~repro_torch.analysis.ops.OpCounter` (the port's counterpart of
lowering and compiling with XLA's cost analysis): FLOPs from torch's
FLOP-formula registry, which holds the hand kernels' ops too, bytes from
the tensors each op reads and writes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

from .findings import Finding, make_finding

__all__ = ["TracedCost", "WorkloadSpec", "audit_benchmark",
           "audit_workload", "trace_cost"]


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Declaration of one benchmark's timed kernel, for the audit.

    ``work`` is in raw units (FLOPs or bytes) per timed call; the
    invocation factory may scale it for display (e.g. /1e9 for GFLOP/s)
    but must derive it from the same formula.
    """

    fn: Callable                     # torch callable to trace
    args: tuple                      # example args (meta tensors ok)
    work: float                      # declared work per timed call
    unit: str                        # "flops" | "bytes"
    dtype: Optional[str] = None      # declared compute dtype, e.g. "float32"
    name: str = "workload"
    tolerance: float = 0.05          # relative declared-vs-traced tolerance

    def __post_init__(self):
        if self.unit not in ("flops", "bytes"):
            raise ValueError(f"unit must be 'flops' or 'bytes', "
                             f"got {self.unit!r}")


@dataclasses.dataclass(frozen=True)
class TracedCost:
    """What the dispatcher says the kernel actually does."""

    flops: float
    bytes_accessed: float
    out_dtypes: tuple[str, ...]
    n_eqns: int                      # ops dispatched (0 = no tensor work)

    def work(self, unit: str) -> float:
        return self.flops if unit == "flops" else self.bytes_accessed


def trace_cost(fn: Callable, args: Sequence[Any]) -> TracedCost:
    """Call ``fn(*args)`` once under the op counter and sum its cost
    (:func:`repro_torch.analysis.ops.count_ops`); ``out_dtypes`` are the
    dtypes of the tensors it returns."""
    import torch
    from torch.utils._pytree import tree_flatten

    from ..analysis.ops import OpCounter

    with OpCounter() as counter:
        out = fn(*args)
    module = counter.module()
    leaves, _ = tree_flatten(out)
    out_dtypes = tuple(str(t.dtype).removeprefix("torch.") for t in leaves
                       if isinstance(t, torch.Tensor))
    return TracedCost(flops=module.flops,
                      bytes_accessed=module.bytes_accessed,
                      out_dtypes=out_dtypes, n_eqns=counter.n_dispatched)


def _anchor(obj) -> tuple[str, int]:
    """Best-effort (path, line) of a python callable, for finding anchors."""
    import inspect
    try:
        path = inspect.getsourcefile(obj) or "<unknown>"
        _, line = inspect.getsourcelines(obj)
    except (TypeError, OSError):
        path, line = "<unknown>", 0
    return path, line


def audit_workload(spec: WorkloadSpec,
                   path: str = "<workload>", line: int = 0) -> list[Finding]:
    """Run the declared-vs-traced checks on one :class:`WorkloadSpec`."""
    findings: list[Finding] = []
    try:
        traced = trace_cost(spec.fn, spec.args)
    except Exception as e:  # trace/compile failed: report, don't crash
        return [make_finding(
            "MS104", path, line,
            f"{spec.name}: tracing the audit spec failed: "
            f"{type(e).__name__}: {e}")]
    traced_work = traced.work(spec.unit)
    if traced.n_eqns == 0 or traced_work == 0.0:
        findings.append(make_finding(
            "MS102", path, line,
            f"{spec.name}: declared {spec.work:.4g} {spec.unit} but the "
            f"traced kernel performs none (ops dispatched={traced.n_eqns}, "
            f"traced {spec.unit}={traced_work:.4g}) — the timed "
            f"computation is dead or returns a constant"))
    else:
        rel = abs(spec.work - traced_work) / traced_work
        if rel > spec.tolerance:
            findings.append(make_finding(
                "MS101", path, line,
                f"{spec.name}: declared {spec.work:.6g} {spec.unit} but "
                f"trace shows {traced_work:.6g} ({rel:.1%} off, tolerance "
                f"{spec.tolerance:.0%}) — every derived {spec.unit}/s "
                f"score is scaled by this error"))
    if spec.dtype is not None and traced.out_dtypes \
            and any(dt != spec.dtype for dt in traced.out_dtypes):
        findings.append(make_finding(
            "MS103", path, line,
            f"{spec.name}: declared dtype {spec.dtype} but traced outputs "
            f"are {', '.join(sorted(set(traced.out_dtypes)))} — check "
            f"the operand dtypes (a demoted kernel does different work "
            f"than declared)"))
    return findings


def audit_benchmark(benchmark, config,
                    name: Optional[str] = None) -> list[Finding]:
    """Audit a tuner benchmark (``config -> InvocationFactory``) for one
    configuration, via its ``audit_spec`` attribute.

    A benchmark without ``audit_spec`` yields a single info-level MS100:
    not auditable is worth knowing, but never fails a run.
    """
    label = name or getattr(benchmark, "__name__", repr(benchmark))
    path, line = _anchor(benchmark)
    make_spec = getattr(benchmark, "audit_spec", None)
    if make_spec is None:
        return [make_finding(
            "MS100", path, line,
            f"{label}: no audit_spec attribute; workload audit skipped "
            f"(attach one to enable declared-vs-traced checking)")]
    try:
        spec = make_spec(config)
    except Exception as e:
        return [make_finding(
            "MS104", path, line,
            f"{label}: audit_spec({config!r}) raised "
            f"{type(e).__name__}: {e}")]
    return audit_workload(spec, path=path, line=line)
