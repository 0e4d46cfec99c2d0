"""Measurement-soundness linter: static audit of benchmarks, timing
harness, and ledger lock discipline (the JAX package's ``repro.lint``,
with its codes, severities, suppression syntax and JSON document).

Three passes, three failure classes the paper's methodology cannot
tolerate:

  1. **workload audit** (:mod:`.workload`, MS1xx) — traces each
     benchmark's kernel once under a dispatch mode and cross-checks the
     *declared* work term the evaluator divides by against the traced
     cost (FLOPs from torch's formula registry, bytes read and written)
  2. **harness lint** (:mod:`.harness`, MS2xx) — AST checks for timing
     pitfalls in torch's idioms: no synchronize before the clock stops,
     wall clocks, ``torch.compile`` or kernel builds inside timed loops
     or invocation factories, discarded results, unseeded RNG, partial
     syncs
  3. **lock discipline** (:mod:`.locks`, MS3xx) — concurrency
     invariants of the shared JSONL stores (flock, inode re-check,
     temp+fsync+replace)

``python -m repro_torch.lint`` is the CLI; ``Tuner.tune(validate=...)``
runs pass 1 as a pre-run gate so a mis-declared workload is caught
before the first trial burns measurement time.
"""

from .findings import (CODES, LINT_VERSION, Finding, WorkloadAuditError,
                       WorkloadAuditWarning, filter_suppressed,
                       findings_to_json, make_finding, worst_severity)
from .harness import lint_file, lint_paths, lint_source
from .locks import (DEFAULT_LOCK_TARGETS, check_lock_discipline,
                    check_lock_source)
from .workload import (TracedCost, WorkloadSpec, audit_benchmark,
                       audit_workload, trace_cost)

__all__ = [
    "CODES", "DEFAULT_LOCK_TARGETS", "Finding", "LINT_VERSION",
    "TracedCost", "WorkloadAuditError", "WorkloadAuditWarning",
    "WorkloadSpec", "audit_benchmark", "audit_workload",
    "check_lock_discipline", "check_lock_source", "filter_suppressed",
    "findings_to_json", "lint_file", "lint_paths", "lint_source",
    "make_finding", "trace_cost", "worst_severity",
]
