"""Render roofline dashboards from persisted trial caches — no re-measuring.

    python -m repro_torch.roofline_report .tuning_sessions/nightly.jsonl
    python -m repro_torch.roofline_report .tuning_sessions --csv roofline.csv
    python -m repro_torch.roofline_report .tuning_sessions \\
        --html roofline.html --history .tuning_sessions/history.jsonl

(with ``src`` on ``PYTHONPATH``). Takes one or more cache files (or
directories of ``*.jsonl`` session caches), groups the trials by
benchmark × hardware fingerprint, extracts the DGEMM incumbent (compute
ceiling ``F_p``) and the per-size TRIAD incumbents (memory slopes
``B_a``), and emits a markdown dashboard per fingerprint — measured peaks
with confidence intervals from the stored Welford moments, an ASCII
roofline with achieved-kernel markers, a %-of-roof gap table — plus a
side-by-side comparison across fingerprints; ``--csv`` also writes the
flat CSV. The output is the JAX package's ``scripts/roofline_report.py``
output, byte for byte, on the same caches.

``--html`` additionally writes a **self-contained HTML dashboard** (inline
CSS/JS/SVG, no external deps); with ``--history LEDGER`` it also embeds
per-series trend lines with CI bands and the regression verdicts from the
performance-history ledger; with ``--trace TRACE`` it embeds a per-trial
drill-down table from a session trace (``python -m repro_torch.tune
--trace``). The report reads records only and needs no card.

``--attribute WORKLOAD`` (``train_step``, ``prefill_step``,
``decode_step``, ``dgemm``) places one workload's ops on the roofs
recovered from the given caches (or, with none, on the H100 SXM's data
sheet peaks, marked theoretical): measured per-op device time on the
card (``--device cuda``, the default), the roofline model's lower bound
with ``--static`` or ``--device cpu``. ``--arch`` picks the model (an
architecture's SMOKE config, or with ``--full`` its full one; default
the tiny dense toy), ``--batch`` and ``--seq-len`` the workload's shape
(for ``decode_step`` the sequence is the cache's slots), the report is
appended to the markdown and the ``--html`` page, and
``--attribution-json`` writes it as JSON.

    python -m repro_torch.roofline_report --attribute train_step \
        --device cpu --attribution-json attr.json
    python -m repro_torch.roofline_report --attribute decode_step \
        --arch granite_3_2b --full --batch 4 --seq-len 4128
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from .core import build_reports, load_trials
from .core.report import (DGEMM_BENCHMARK, TRIAD_BENCHMARK, render_csv,
                          render_markdown)


def _attribute(args):
    """The ``--attribute`` report (None after a usage error, printed)."""
    import json

    from .configs import get
    from .core.roofline import H100_SXM
    from .device import resolve_device
    from .models.workloads import build_workload
    from .obs.attribution import Roofs, attribute, roofs_from_trials

    roofs = roofs_from_trials(args.paths) if args.paths else None
    if roofs is None:
        # no empirical roofs in the caches: classify against the card's
        # data-sheet peaks, clearly marked
        roofs = Roofs(peak_flops=H100_SXM.peak_flops,
                      bandwidths=dict(H100_SXM.mem_bandwidths),
                      fingerprint=f"{H100_SXM.name} (theoretical)")
        print(f"note: no empirical roofs recovered; classifying "
              f"against {H100_SXM.name} theoretical peaks",
              file=sys.stderr)
    device = resolve_device(args.device)
    shape = {k: v for k, v in (("batch_size", args.batch),
                               ("seq_len", args.seq_len)) if v is not None}
    try:
        arch = get(args.arch) if args.full else args.arch
        workload = build_workload(args.attribute, arch, device=device,
                                  **shape)
    except (KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return None
    attribution = attribute(workload, roofs, force_static=args.static)
    print(f"attributed {len(attribution.ops)} ops of "
          f"{args.attribute} ({attribution.mode} mode, "
          f"unattributed {attribution.unattributed_frac * 100:.1f}%)",
          file=sys.stderr)
    if args.attribution_json:
        pathlib.Path(args.attribution_json).write_text(
            json.dumps(attribution.to_json(), indent=2), encoding="utf-8")
        print(f"wrote {args.attribution_json}")
    return attribution


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.roofline_report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="cache files or directories of *.jsonl caches")
    ap.add_argument("--dgemm-benchmark", default=DGEMM_BENCHMARK,
                    help="benchmark name supplying the compute peak")
    ap.add_argument("--triad-benchmark", default=TRIAD_BENCHMARK,
                    help="benchmark name supplying the bandwidth slopes")
    ap.add_argument("--confidence", type=float, default=0.99)
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the markdown dashboard here (default stdout)")
    ap.add_argument("--csv", default=None, metavar="PATH",
                    help="also write the flat CSV (curves, marks, gaps)")
    ap.add_argument("--html", default=None, metavar="PATH",
                    help="also write a self-contained HTML dashboard "
                         "(inline CSS/JS/SVG, no external deps)")
    ap.add_argument("--history", default=None, metavar="LEDGER",
                    help="run-ledger JSONL to embed trend lines and "
                         "regression verdicts into the --html dashboard")
    ap.add_argument("--trace", default=None, metavar="TRACE",
                    help="session trace JSONL (python -m repro_torch.tune "
                         "--trace) to embed a per-trial drill-down table "
                         "into the --html dashboard")
    ap.add_argument("--max-trial-rows", type=int, default=200,
                    metavar="N",
                    help="row cap of the --trace drill-down table "
                         "(default 200)")
    ap.add_argument("--attribute", default=None, metavar="WORKLOAD",
                    help="attribute one workload's ops against the "
                         "empirical roofs (train_step | prefill_step | "
                         "decode_step | dgemm)")
    ap.add_argument("--arch", default=None, metavar="ARCH",
                    help="smoke-scale model architecture for --attribute "
                         "(default: tiny dense toy; see repro_torch.configs)")
    ap.add_argument("--full", action="store_true",
                    help="attribute --arch's full config, not its smoke "
                         "config")
    ap.add_argument("--batch", type=int, default=None, metavar="N",
                    help="batch of the --attribute workload")
    ap.add_argument("--seq-len", type=int, default=None, metavar="S",
                    help="sequence of the --attribute workload (decode: "
                         "the cache's slots)")
    ap.add_argument("--static", action="store_true",
                    help="force static attribution (skip the profiled "
                         "invocation)")
    ap.add_argument("--attribution-json", default=None, metavar="PATH",
                    help="write the --attribute report as JSON (CI "
                         "artifact)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the --attribute workload runs (default: "
                         "cuda; raises when no card is visible)")
    args = ap.parse_args(argv)

    if not args.paths and not args.attribute:
        ap.error("at least one cache path is required (or --attribute)")
    if args.full and not args.arch:
        ap.error("--full needs --arch")

    trials = []
    for p in args.paths:
        path = pathlib.Path(p)
        if not path.exists():
            print(f"error: no such cache: {p}", file=sys.stderr)
            return 2
        trials.extend(load_trials(path))
    if not trials and not args.attribute:
        print("error: no readable trials in the given cache(s)",
              file=sys.stderr)
        return 1

    reports, skipped = build_reports(
        trials, dgemm_benchmark=args.dgemm_benchmark,
        triad_benchmark=args.triad_benchmark, confidence=args.confidence)
    if not reports:
        # a --history ledger can still carry an HTML trend dashboard even
        # when no fingerprint has roofline-complete (dgemm+triad) trials
        print("no reportable fingerprint — need unpruned trials of "
              f"both {args.dgemm_benchmark!r} and {args.triad_benchmark!r}:",
              file=sys.stderr)
        for fp, reason in skipped:
            print(f"  {fp}: {reason}", file=sys.stderr)
        if not (args.html and args.history) and not args.attribute:
            print("error: nothing to render", file=sys.stderr)
            return 1

    attribution = None
    if args.attribute:
        attribution = _attribute(args)
        if attribution is None:
            return 2

    # in the ledger-only continue-path reports is empty: --out/--csv still
    # write (a header-only dashboard/CSV), never silently skip a requested
    # artifact while exiting 0
    markdown = render_markdown(reports, skipped)
    if attribution is not None:
        markdown = markdown + "\n" + attribution.to_markdown()
    if args.out:
        pathlib.Path(args.out).write_text(markdown, encoding="utf-8")
        print(f"wrote {args.out}")
    elif reports or attribution is not None:
        sys.stdout.write(markdown)
    if args.csv:
        pathlib.Path(args.csv).write_text(render_csv(reports),
                                          encoding="utf-8")
        print(f"wrote {args.csv}")
    if args.html:
        import time

        from .history import RunLedger, write_dashboard

        ledger = None
        if args.history:
            history_path = pathlib.Path(args.history)
            if not history_path.exists():
                print(f"error: no such ledger: {args.history}",
                      file=sys.stderr)
                return 2
            ledger = RunLedger(history_path)
        trial_rows = ()
        if args.trace:
            trace_path = pathlib.Path(args.trace)
            if not trace_path.exists():
                print(f"error: no such trace: {args.trace}",
                      file=sys.stderr)
                return 2
            from .obs import load_events, trial_summaries
            trial_rows = trial_summaries(load_events(trace_path))
        stamp = time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime())
        write_dashboard(args.html, reports, skipped, ledger=ledger,
                        title="Roofline & performance history",
                        subtitle=f"generated {stamp} from "
                                 f"{len(trials)} cached trials",
                        confidence=args.confidence, trials=trial_rows,
                        attribution=attribution,
                        max_trial_rows=args.max_trial_rows)
        print(f"wrote {args.html}")
    return 0


if __name__ == "__main__":
    import os

    try:
        sys.exit(main())
    except BrokenPipeError:
        # stdout closed early (e.g. piped into `head`) — not an error
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
