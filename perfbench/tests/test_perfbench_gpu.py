"""On the card: one short run of each cell through the entry, as the
driver runs it, and the result line's shape. Skips without a card; run
on the card with ``python -m pytest perfbench/tests -m gpu``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.lib import spec

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in spec.load()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_card(workload, card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(2 ** 32 + 17), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    assert list(line)[-1] == "checks"
    names = {m["name"] for m in spec.cell(workload).end_to_end}
    assert set(line["metrics"]) == names
