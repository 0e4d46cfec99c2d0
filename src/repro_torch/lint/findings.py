"""Finding model for the measurement-soundness linter.

Every check in the three passes (workload audit, harness lint, lock
discipline — see :mod:`repro_torch.lint`) reports :class:`Finding`s carrying a
**stable code** from :data:`CODES`. Codes are part of the tool's contract:
CI configs, suppression comments and the JSON report all key on them, so a
code is never renumbered or reused once released. The table, the version
and the JSON document are the JAX package's (``repro.lint.findings``),
so one suppression comment and one CI gate serve both packages; the
titles keep the reference's words, and the port's harness pass reads
them in torch's idioms (``block_until_ready`` is a synchronize,
``jax.jit`` is ``torch.compile`` or a kernel build).

Suppression is per-line, in the linted source itself::

    t1 = time.time() - t0   # lint: ok=MS202
    risky_call()            # lint: ok          (suppresses every code)

The marker must sit on the exact line a finding anchors to.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Iterable, Optional

__all__ = ["CODES", "Finding", "LINT_VERSION", "WorkloadAuditError",
           "WorkloadAuditWarning", "filter_suppressed", "findings_to_json",
           "make_finding", "worst_severity"]

LINT_VERSION = 1

#: severity ordering, mildest first; exit codes treat >= "warning" as dirty
_SEVERITIES = ("info", "warning", "error")

#: code -> (pass name, default severity, short title). Codes are stable:
#: MS1xx = workload audit, MS2xx = harness lint, MS3xx = lock discipline.
CODES: dict[str, tuple[str, str, str]] = {
    "MS100": ("workload", "info",
              "benchmark declares no audit spec; workload audit skipped"),
    "MS101": ("workload", "error",
              "declared work term diverges from traced cost"),
    "MS102": ("workload", "error",
              "timed computation is dead or constant-folded"),
    "MS103": ("workload", "warning",
              "traced compute dtype differs from the declared dtype"),
    "MS104": ("workload", "warning",
              "workload audit could not trace the benchmark"),
    "MS201": ("harness", "warning",
              "timed region has device work but no block_until_ready"),
    "MS202": ("harness", "warning",
              "time.time() used in a timing path (use perf_counter)"),
    "MS203": ("harness", "warning",
              "jax.jit invoked inside a timed loop"),
    "MS204": ("harness", "warning",
              "device computation discarded inside a timed region"),
    "MS205": ("harness", "warning",
              "unseeded RNG in benchmark data generation"),
    "MS206": ("harness", "warning",
              "sync covers only part of the timed computation's outputs"),
    "MS207": ("harness", "warning",
              "jax.jit inside an invocation factory bypasses the "
              "executable cache"),
    "MS301": ("locks", "error",
              "shared JSONL write outside an exclusive flock"),
    "MS302": ("locks", "error",
              "flock on a replaceable file without post-lock inode re-check"),
    "MS303": ("locks", "error",
              "shared-file rewrite without temp + fsync + os.replace"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One linter finding, anchored to a source location."""

    code: str
    path: str          # repo-relative when produced by the lint CLI
    line: int          # 1-based; 0 when the finding is file/benchmark-level
    message: str
    severity: str = "warning"
    pass_name: str = ""

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.code} [{self.severity}] {self.message}"

    def to_json(self) -> dict:
        return {"code": self.code, "path": self.path, "line": self.line,
                "severity": self.severity, "pass": self.pass_name,
                "message": self.message}


def make_finding(code: str, path: str, line: int, message: str) -> Finding:
    """Build a finding with the code's registered pass/severity."""
    pass_name, severity, _title = CODES[code]
    return Finding(code=code, path=str(path), line=line, message=message,
                   severity=severity, pass_name=pass_name)


class WorkloadAuditError(RuntimeError):
    """Raised by the engine's strict pre-run validation: the benchmark's
    declared workload failed the audit, so no trial was executed."""

    def __init__(self, findings: Iterable[Finding]):
        self.findings = tuple(findings)
        super().__init__("workload audit failed:\n" + "\n".join(
            f"  {f.render()}" for f in self.findings))


class WorkloadAuditWarning(UserWarning):
    """Category for warn-mode pre-run validation findings."""


_SUPPRESS_RE = re.compile(r"#\s*lint:\s*ok(?:=(?P<codes>[A-Z0-9, ]+))?")


def _suppressed_codes(source_line: str) -> Optional[set[str]]:
    """Codes suppressed on this line: an empty set means *all* codes."""
    m = _SUPPRESS_RE.search(source_line)
    if m is None:
        return None
    codes = m.group("codes")
    if codes is None:
        return set()
    return {c.strip() for c in codes.split(",") if c.strip()}


def filter_suppressed(findings: Iterable[Finding]) -> list[Finding]:
    """Drop findings whose anchor line carries a ``# lint: ok`` marker."""
    out: list[Finding] = []
    sources: dict[str, list[str]] = {}
    for f in findings:
        if f.line > 0:
            if f.path not in sources:
                try:
                    text = Path(f.path).read_text(encoding="utf-8")
                except OSError:
                    text = ""
                sources[f.path] = text.splitlines()
            lines = sources[f.path]
            if 0 < f.line <= len(lines):
                codes = _suppressed_codes(lines[f.line - 1])
                if codes is not None and (not codes or f.code in codes):
                    continue
        out.append(f)
    return out


def worst_severity(findings: Iterable[Finding]) -> Optional[str]:
    worst = -1
    for f in findings:
        worst = max(worst, _SEVERITIES.index(f.severity))
    return _SEVERITIES[worst] if worst >= 0 else None


def findings_to_json(findings: Iterable[Finding]) -> dict:
    """The stable ``python -m repro_torch.lint --json`` document."""
    fs = sorted(findings, key=lambda f: (f.path, f.line, f.code))
    counts = {"error": 0, "warning": 0, "info": 0}
    for f in fs:
        counts[f.severity] = counts.get(f.severity, 0) + 1
    return {"lint_version": LINT_VERSION,
            "findings": [f.to_json() for f in fs],
            "summary": counts}
