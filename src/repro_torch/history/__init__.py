"""Performance history: run ledger, regression gating, trend dashboards.

The tuning engine measures a machine's roofline *once*; this package makes
the repo longitudinally self-aware across runs. Three layers:

  * :mod:`~repro_torch.history.ledger` — an append-only JSONL **run ledger**:
    one record per completed tuning session (benchmark × hardware
    fingerprint), carrying the incumbent config, its exact pooled Welford
    moments, and a monotonically-assigned run index. Populated
    automatically by ``TuningSession``/``Tuner.tune(ledger=...)``, and
    backfillable from an existing trial cache.
  * :mod:`~repro_torch.history.regression` — statistical drift detection: the
    newest run's incumbent mean against the best historical run, via a
    Welch CI on the difference of means (``ReservoirBootstrap`` fallback
    at low sample counts), classified improved / flat / regressed with
    the same error discipline the paper applies to early termination.
    ``python -m repro_torch.perf_gate`` turns the verdicts into a CI
    exit code.
  * :mod:`~repro_torch.history.render` — self-contained single-file HTML
    dashboards (inline CSS/JS/SVG, no external deps) with per-series
    trend lines, CI bands, roofline summaries and verdicts, plus ASCII
    sparklines for terminals.

Ledger format and gate semantics: ``docs/history.md`` (the JAX
package's; the port writes and reads the same bytes). Host-side only:
nothing here touches a device.
"""

from .ledger import (LEDGER_VERSION, BoundLedger, RunLedger, RunRecord,
                     record_from_result)
from .regression import (RegressionReport, RunComparison, SeriesVerdict,
                         compare_runs, detect_regressions, welch_interval)
from .render import (ascii_sparkline, render_html, render_trend_text,
                     write_dashboard)

__all__ = [
    "LEDGER_VERSION", "BoundLedger", "RunLedger", "RunRecord",
    "record_from_result",
    "RegressionReport", "RunComparison", "SeriesVerdict", "compare_runs",
    "detect_regressions", "welch_interval",
    "ascii_sparkline", "render_html", "render_trend_text",
    "write_dashboard",
]
