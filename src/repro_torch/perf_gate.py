"""CI performance gate over the run ledger: fail on confirmed regressions.

    python -m repro_torch.perf_gate                    # default ledger
    python -m repro_torch.perf_gate .tuning_sessions/history.jsonl
    python -m repro_torch.perf_gate --dry-run          # never fails CI

(with ``src`` on ``PYTHONPATH``). For every (benchmark, hardware
fingerprint) series in the ledger, the newest run's incumbent mean is
compared against the best historical run with a Welch CI on the
difference of means (reservoir-bootstrap fallback at low sample counts).
A drop is only *confirmed* — and only then does the gate exit non-zero —
when the CI excludes zero AND the effect exceeds ``--min-effect``
(default 2%, the paper's early-termination error budget). Improvements
and statistically-insignificant wobble pass. The gate reads records only:
it runs on the host and needs no card, whatever the ledger's
fingerprints name. Its output is the JAX package's
``scripts/perf_gate.py`` output, byte for byte, on the same ledger; that
script's ``--harness`` check is left out (the port's is ``python -m
repro_torch.bench.harness --check``).

Under GitHub Actions (``GITHUB_ACTIONS=1``) every confirmed regression
additionally emits a `workflow command
<https://docs.github.com/actions/reference/workflow-commands-for-github-actions>`_
annotation — ``::error`` (``::warning`` in ``--dry-run``) with
``file=<ledger>,line=<N>`` pointing at the candidate run's exact ledger
record, so the verdict surfaces inline on the PR's checks tab.

Exit codes: 0 clean (or ``--dry-run``), 1 confirmed regression(s),
2 usage errors (missing ledger outside ``--dry-run``).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

from .core import Direction
from .history import RunLedger, detect_regressions
from .history.regression import MIN_COUNT_WELCH, MIN_EFFECT

DEFAULT_LEDGER = ".tuning_sessions/history.jsonl"


def _esc_data(s: str) -> str:
    """Workflow-command message escaping (the documented set)."""
    return s.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")


def _esc_prop(s: str) -> str:
    """Workflow-command property escaping: the message set plus the
    property delimiters themselves."""
    return _esc_data(s).replace(":", "%3A").replace(",", "%2C")


def _ledger_line(path: pathlib.Path, benchmark: str, fingerprint: str,
                 run: int):
    """1-based line number of one run record in the ledger file, or None
    (compacted away, or the file changed since the report was built)."""
    try:
        lines = path.read_text(encoding="utf-8").splitlines()
    except OSError:
        return None
    for n, line in enumerate(lines, 1):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if (isinstance(rec, dict) and rec.get("benchmark") == benchmark
                and rec.get("fingerprint") == fingerprint
                and rec.get("run") == run):
            return n
    return None


def emit_annotations(report, ledger_path: pathlib.Path,
                     dry_run: bool = False, out=None) -> int:
    """One GitHub Actions annotation per confirmed regression; returns
    how many were emitted. ``--dry-run`` downgrades them to warnings
    (reported on the PR but never red)."""
    out = sys.stdout if out is None else out
    level = "warning" if dry_run else "error"
    n = 0
    for s in report.series:
        if s.verdict != "regressed" or s.comparison is None:
            continue
        c = s.comparison
        loc = f"file={_esc_prop(str(ledger_path))}"
        line = _ledger_line(ledger_path, s.benchmark, s.fingerprint,
                            c.candidate.run)
        if line is not None:
            loc += f",line={line}"
        title = _esc_prop(f"perf regression: {s.benchmark}")
        msg = _esc_data(
            f"{s.benchmark} @ {s.fingerprint}: run {c.candidate.run} mean "
            f"{c.candidate.mean:.4g} vs best prior {c.baseline.mean:.4g} "
            f"({c.rel_delta:+.2%}, CI [{c.interval.lo:.4g}, "
            f"{c.interval.hi:.4g}])")
        print(f"::{level} {loc},title={title}::{msg}", file=out)
        n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.perf_gate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ledger", nargs="?", default=DEFAULT_LEDGER,
                    help=f"run-ledger JSONL path (default {DEFAULT_LEDGER})")
    ap.add_argument("--benchmark", default=None,
                    help="gate only this benchmark's series")
    ap.add_argument("--fingerprint", default=None,
                    help="gate only this hardware fingerprint's series")
    ap.add_argument("--confidence", type=float, default=0.99)
    ap.add_argument("--min-effect", type=float, default=MIN_EFFECT,
                    metavar="FRAC",
                    help="relative drift below this is never confirmed "
                         f"(default {MIN_EFFECT:g} — the paper's error "
                         "budget)")
    ap.add_argument("--min-count", type=int, default=MIN_COUNT_WELCH,
                    help="pooled samples per run required for the Welch "
                         "path; below it the bootstrap fallback runs")
    ap.add_argument("--direction", default=None,
                    choices=("maximize", "minimize"),
                    help="override the direction stamped on the records")
    ap.add_argument("--dry-run", action="store_true",
                    help="report verdicts but always exit 0 (non-blocking "
                         "CI step; also tolerates a missing ledger)")
    args = ap.parse_args(argv)

    path = pathlib.Path(args.ledger)
    if not path.exists():
        msg = f"perf-gate: no ledger at {path}"
        if args.dry_run:
            print(f"{msg} — nothing to gate (dry-run, ok)")
            return 0
        print(f"error: {msg}", file=sys.stderr)
        return 2

    direction = Direction(args.direction) if args.direction else None
    report = detect_regressions(
        RunLedger(path), benchmark=args.benchmark,
        fingerprint=args.fingerprint, confidence=args.confidence,
        direction=direction, min_effect=args.min_effect,
        min_count=args.min_count)
    sys.stdout.write(report.render_text())
    if os.environ.get("GITHUB_ACTIONS", "").lower() in ("1", "true"):
        emit_annotations(report, path, dry_run=args.dry_run)
    if args.dry_run:
        if not report.ok:
            print("perf-gate: dry-run — regressions reported but not "
                  "enforced")
        return 0
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
