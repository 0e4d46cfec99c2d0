"""The control comes out not correct: the reference, put in the
program's place in the precision below the configuration's (fp8 for the
bfloat16 models, TF32 for the float32 GEMM), read at the same inputs as
a run of the program, fails at least one of the cell's limits. At each
cell's test size on the CPU; ``perfbench/control.py`` reads the same on
the chip at the cells' own sizes."""

import pytest

from perfbench import control
from perfbench.lib import judge, spec

CELLS = ["granite-3-2b.tune_gemm_f32", "granite-3-2b.serve_decode_32k",
         "granite-3-2b.serve_prefill_4k"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(workload, small):
    r = control.readings(workload, 2 ** 33 + 5, 0.2, True, device="cpu",
                         overrides=small[workload])
    lim = spec.cell(workload, small[workload]).limits
    assert all(judge.passed(r["program"][k], lim[k]) for k in lim), r
    assert not all(judge.passed(r["control"][k], lim[k]) for k in lim), r
