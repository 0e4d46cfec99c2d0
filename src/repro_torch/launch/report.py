"""Render dry-run JSONL records into the experiment tables (the JAX
package's ``launch/report.py``; a copy, as the port imports nothing of
the JAX package).

The fit column holds a cell against the H100's 80 GB where the
reference's holds it against TPU v5e's 16 GB. It keeps the reference's
sum ``peak_gb + args_gb``, although ``peak_gb`` already holds the
arguments (it is args + temp + out), so that the two packages' tables
agree on the same records.

  PYTHONPATH=src python -m repro_torch.launch.report build/dryrun_torch.jsonl
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

__all__ = ["ARCH_ORDER", "FIT_GB", "SHAPE_ORDER", "dryrun_table", "load",
           "main", "roofline_table", "summary"]

ARCH_ORDER = ["command-r-plus-104b", "granite-3-2b", "minicpm-2b", "gemma-2b",
              "whisper-base", "granite-moe-1b-a400m", "mixtral-8x22b",
              "llama-3.2-vision-11b", "mamba2-130m", "zamba2-2.7b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
#: the H100's device memory, GB
FIT_GB = 80


def _canon(arch: str) -> str:
    arch = arch.replace("_", "-").replace("llama-3-2", "llama-3.2") \
        .replace("zamba2-2-7b", "zamba2-2.7b")
    return arch


def load(paths: list[str]) -> list[dict]:
    records = []
    for p in paths:
        with open(p) as f:
            records += [json.loads(line) for line in f]
    # normalize arch ids, dedupe on (arch, shape, mesh), keep last
    seen = {}
    for r in records:
        r = {**r, "arch": _canon(r["arch"])}
        seen[(r["arch"], r["shape"], r["mesh"])] = r
    return list(seen.values())


def _key(r):
    arch = _canon(r["arch"])
    a = ARCH_ORDER.index(arch) if arch in ARCH_ORDER else 99
    s = SHAPE_ORDER.index(r["shape"]) if r["shape"] in SHAPE_ORDER else 99
    return (a, s, r["mesh"])


def dryrun_table(records: list[dict]) -> str:
    rows = ["| arch | shape | mesh | status | compile_s | peak GB/dev | "
            f"fits H100({FIT_GB}G) |",
            "|---|---|---|---|---|---|---|"]
    for r in sorted(records, key=_key):
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"SKIP (full-attn, long ctx) | - | - | - |")
            continue
        fits = "yes" if r.get("peak_gb", 1e9) + r.get("args_gb", 0) \
            <= FIT_GB else "**no**"
        rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                    f"{r['status']} | {r.get('compile_s', '-')} | "
                    f"{r.get('peak_gb', '-')} | {fits} |")
    return "\n".join(rows)


def roofline_table(records: list[dict], mesh: str = "single") -> str:
    rows = ["| arch | shape | compute ms | memory ms | coll ms | dominant | "
            "useful | MFU-bound | top collectives |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(records, key=_key):
        if r["mesh"] != mesh or r["status"] != "ok" or "dominant" not in r:
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_ms']} | "
            f"{r['memory_ms']} | {r['collective_ms']} | {r['dominant']} | "
            f"{r['useful_flops_ratio']} | {r['mfu_bound']} | "
            f"{r.get('collectives', '')[:60]} |")
    return "\n".join(rows)


def summary(records: list[dict]) -> str:
    ok = [r for r in records if r["status"] == "ok"]
    skip = [r for r in records if r["status"] == "skipped"]
    err = [r for r in records if r["status"] == "error"]
    lines = [f"cells: {len(ok)} ok, {len(skip)} skipped (documented), "
             f"{len(err)} failed"]
    if err:
        for r in err:
            lines.append(f"  FAILED {r['arch']} {r['shape']} {r['mesh']}: "
                         f"{r.get('error', '')[:100]}")
    return "\n".join(lines)


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="+")
    args = ap.parse_args(argv)
    records = load(args.paths)
    print("### Dry-run summary\n")
    print(summary(records))
    print("\n### Dry-run table (both meshes)\n")
    print(dryrun_table(records))
    print("\n### Roofline table (single pod, 256 H100s, estimates)\n")
    print(roofline_table(records, "single"))
    print("\n### Roofline table (multi-pod, 512 H100s, estimates)\n")
    print(roofline_table(records, "multi"))


if __name__ == "__main__":
    main()
