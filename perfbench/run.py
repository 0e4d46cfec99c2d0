"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s``),
``breakdown`` (``--trace 1``), ``card`` (the card's name and power
limit) and, last, ``checks``: each number that decides ``correct`` with
its limit, which also end standard error. The run exits with another
code than 0, printing no result, on a machine without the cards the
cell asks for, and when a module of JAX or of the JAX package was loaded
in the process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    env.set_cache_dirs(ROOT)          # before torch is imported

    from perfbench.lib.runner import run_cell
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t0=T0)
    except env.NoChip as exc:
        print(f"perfbench: no chip for {args.workload}: {exc}",
              file=sys.stderr)
        return 2
    loaded = env.forbidden_modules()
    if loaded:
        print(f"perfbench: forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = env.power_limit()
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
