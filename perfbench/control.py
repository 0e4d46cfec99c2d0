"""The readings the limits of ``correct`` are set from, at a cell's own
size on the chip: the program's numbers on many seeds, and on some of
them the control's, the reference in the precision below the
configuration's (fp8 for a bfloat16 model, TF32 for the float32 GEMM)
put in the program's place at the same prompts and served tokens.

    python3 perfbench/control.py --workload <cell> --seeds 12 \\
        --control-seeds 3 --first-seed <n> --seconds <s> [--out FILE] \\
        [--fault NAME]

One process: each seed makes its inputs, warms up, runs a short window
(``--seconds``; at least as many units as a run compares), frees the
program's state and reads the numbers. Prints one JSON line a seed and
the largest program reading and smallest control reading of each
number. With ``--fault state`` the program runs with
``perfbench/lib/faults.py``'s ``state_unchanged`` planted (the control
is not read). The
benchmark's own runs never run this.
"""

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import env  # noqa: E402

#: the control's precision for a configuration's stated dtype
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def readings(workload: str, seed: int, seconds: float, control: bool,
             device: str = "cuda", overrides=None) -> dict:
    """The program's numbers on ``seed`` and, with ``control``, the
    control's at the same inputs."""
    import torch
    from perfbench.lib import spec
    from perfbench.lib.runner import Run
    cell = spec.cell(workload, overrides)
    driver = spec.kind(cell.traffic["kind"])
    run = Run(cell=cell, seed=seed, device=torch.device(device))
    driver.setup(run)
    driver.window(run, seconds)
    driver.release(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "units": run.attempted,
           "program": driver.judge(run, "f32")}
    if control:
        dtype = cell.traffic.get("dtype") or cell.config["port_config"][
            "dtype"]
        out["control"] = driver.judge(run, CONTROL[dtype])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    ap.add_argument("--fault", choices=["state"],
                    help="plant faults.state_unchanged in the program")
    args = ap.parse_args(argv)
    env.set_cache_dirs(ROOT)          # before torch is imported
    env.require_chips(1)
    from perfbench.lib import faults
    rows = []
    for i in range(args.seeds):
        t0 = time.perf_counter()
        with (faults.state_unchanged() if args.fault
              else contextlib.nullcontext()):
            row = readings(args.workload, args.first_seed + i, args.seconds,
                           i < args.control_seeds and not args.fault)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "fault": args.fault,
               "card": env.power_limit(),
               "program_max": {}, "control_min": {}}
    for name in rows[0]["program"]:
        summary["program_max"][name] = max(r["program"][name] for r in rows)
        ctrl = [r["control"][name] for r in rows if "control" in r]
        if ctrl:
            summary["control_min"][name] = min(ctrl)
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}))
    loaded = env.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
