"""Inject generated dry-run/roofline tables into a markdown document (the
JAX package's ``scripts/finalize_experiments.py``, over the port's
:mod:`repro_torch.launch.report`).

    PYTHONPATH=src python -m repro_torch.finalize_experiments build/dryrun_torch.jsonl
    PYTHONPATH=src python -m repro_torch.finalize_experiments build/dryrun_torch.jsonl --in-place
    PYTHONPATH=src python -m repro_torch.finalize_experiments --check

The target document must contain the ``<!-- DRYRUN_TABLE -->`` and
``<!-- ROOFLINE_TABLE -->`` markers; a document missing either fails with
a clear error instead of silently writing nothing. Default mode prints
the finalized document to stdout; ``--in-place`` rewrites the file;
``--check`` only verifies the markers are present (no records needed).

Exit codes: 0 ok, 1 markers missing, 2 usage errors (missing files).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Optional

from .launch.report import dryrun_table, load, roofline_table, summary

__all__ = ["MARKERS", "finalize", "main", "missing_markers"]

MARKERS = ("<!-- DRYRUN_TABLE -->", "<!-- ROOFLINE_TABLE -->")


def missing_markers(text: str) -> list[str]:
    return [m for m in MARKERS if m not in text]


def finalize(text: str, records: list[dict]) -> str:
    dry = summary(records) + "\n\n" + dryrun_table(records)
    roof = (roofline_table(records, "single")
            + "\n\n#### Multi-pod (512 chips)\n\n"
            + roofline_table(records, "multi"))
    return (text.replace("<!-- DRYRUN_TABLE -->", dry)
                .replace("<!-- ROOFLINE_TABLE -->", roof))


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.finalize_experiments",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("records", nargs="*", metavar="JSONL",
                    help="dry-run result files (repro_torch.launch.dryrun "
                         "output)")
    ap.add_argument("--file", default="EXPERIMENTS.md", metavar="DOC",
                    help="markdown document carrying the markers "
                         "(default EXPERIMENTS.md)")
    ap.add_argument("--in-place", action="store_true",
                    help="rewrite DOC instead of printing to stdout")
    ap.add_argument("--check", action="store_true",
                    help="only verify DOC contains the markers; writes "
                         "nothing and needs no records")
    args = ap.parse_args(argv)

    doc = pathlib.Path(args.file)
    if not doc.exists():
        print(f"error: no such document: {doc}", file=sys.stderr)
        return 2
    text = doc.read_text(encoding="utf-8")
    absent = missing_markers(text)
    if absent:
        print(f"error: {doc} is missing marker(s): {', '.join(absent)} — "
              "nothing would be injected", file=sys.stderr)
        return 1
    if args.check:
        print(f"{doc}: all {len(MARKERS)} markers present")
        return 0
    if not args.records:
        print("error: no record files given (or use --check)",
              file=sys.stderr)
        return 2
    for rec in args.records:
        if not pathlib.Path(rec).exists():
            print(f"error: no such record file: {rec}", file=sys.stderr)
            return 2
    records = load(args.records)
    finalized = finalize(text, records)
    if args.in_place:
        doc.write_text(finalized, encoding="utf-8")
        print(f"{doc} updated: {summary(records).splitlines()[0]}")
    else:
        sys.stdout.write(finalized)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
