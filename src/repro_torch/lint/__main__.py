"""Measurement-soundness linter CLI (the JAX package's ``scripts/lint.py``).

    python -m repro_torch.lint                     # all three passes
    python -m repro_torch.lint --no-trace          # skip pass 1
    python -m repro_torch.lint --json              # machine output
    python -m repro_torch.lint --device cpu        # pass 1 bound to the host
    python -m repro_torch.lint src/repro_torch/core    # explicit paths

(with ``src`` on ``PYTHONPATH``). Passes (stable finding codes —
``repro_torch.lint.CODES``):

  1. workload audit (MS1xx): trace each benchmark of
     ``repro_torch.bench.common.audited_workloads(device)`` once on
     ``meta`` tensors and cross-check its declared work term against the
     traced cost. The benchmarks are bound to ``--device`` (``cuda``, the
     default, raises without a card); skip the pass with ``--no-trace``.
  2. harness lint (MS2xx): AST timing-pitfall checks over the given
     paths (default: ``src/repro_torch``, ``chip_smoke.py`` and
     ``tests/test_torch_*.py``).
  3. lock discipline (MS3xx): concurrency invariants of the shared
     JSONL stores (trial cache, run ledger).

Exit codes: 0 = clean (info-level findings allowed), 1 = warning/error
findings, 2 = usage or internal failure. ``--json`` prints the stable
document (``lint_version``, per-finding code/path/line/severity/pass,
summary counts) for CI artifacts.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from . import (check_lock_discipline, filter_suppressed, findings_to_json,
               lint_paths, worst_severity)

REPO = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py", "tests/test_torch_*.py")

#: generated trees the AST passes skip
EXCLUDE = (".tuning_sessions", "__pycache__", ".git")


def _expand(patterns) -> list[str]:
    """Repo-relative defaults, globs expanded."""
    out: list[str] = []
    for pat in patterns:
        out.extend(str(p) for p in sorted(REPO.glob(pat)))
    return out


def _relativize(findings, root: pathlib.Path):
    out = []
    for f in findings:
        try:
            rel = str(pathlib.Path(f.path).resolve().relative_to(root))
        except ValueError:
            rel = f.path
        out.append(type(f)(code=f.code, path=rel, line=f.line,
                           message=f.message, severity=f.severity,
                           pass_name=f.pass_name))
    return out


def run_workload_audit(device: str = "cuda") -> list:
    """Pass 1 over every registered benchmark (one sample config each)."""
    from ..bench.common import audited_workloads
    from . import audit_benchmark
    findings = []
    for name, (bench, cfg) in sorted(audited_workloads(device).items()):
        findings.extend(audit_benchmark(bench, cfg, name=name))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs for the AST passes "
                         f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the stable JSON report on stdout")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip pass 1 (the workload audit traces every "
                         "registered benchmark)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device pass 1's benchmarks are bound to "
                         "(default: cuda; raises when no card is visible)")
    args = ap.parse_args(argv)

    paths = args.paths or _expand(DEFAULT_PATHS)
    for p in paths:
        if not pathlib.Path(p).exists():
            print(f"lint: no such path: {p}", file=sys.stderr)
            return 2

    findings = []
    try:
        findings += lint_paths(paths, exclude=EXCLUDE)
        findings += check_lock_discipline(root=REPO)
        if not args.no_trace:
            findings += run_workload_audit(args.device)
    except Exception as e:   # internal failure must not read as "clean"
        print(f"lint: internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2

    findings = _relativize(filter_suppressed(findings), REPO)
    doc = findings_to_json(findings)
    if args.as_json:
        print(json.dumps(doc, indent=2))
    else:
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.code)):
            print(f.render())
        s = doc["summary"]
        print(f"lint: {s['error']} error(s), {s['warning']} warning(s), "
              f"{s['info']} info")
    return 1 if worst_severity(findings) in ("warning", "error") else 0


if __name__ == "__main__":
    raise SystemExit(main())
