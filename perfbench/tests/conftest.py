"""Shared set-up of the benchmark's CPU tests: the port on the path, and
each cell at a size a test can hold (every width cut, the dtype kept)."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

_DENSE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
          "d_ff": 128, "vocab_size": 512}

#: limits at the test sizes, set from readings there (the program's
#: largest and the control's smallest over five seeds of each serving
#: cell: logit_rms 0.0108 and 0.1102, cache_rms 0.0061 and 0.0853, gap
#: 0.0007 and 0; a decode step that leaves the cache unchanged reads
#: cache_rms 1)
_TEST_LIMITS = {"gap": 0.05, "logit_rms": 0.04, "cache_rms": 0.025}

#: each cell of BENCHMARK.json cut to a test's size
SMALL = {
    "granite-3-2b.tune_gemm_f32": {
        "config": {"hidden_size": 64, "intermediate_size": 96},
        "traffic": {"tokens": 80, "quick_settings": True,
                    "peak_window_s": 0.01}},
    "granite-3-2b.serve_decode_32k": {
        "port_config": _DENSE,
        "traffic": {"batch": 2, "context": 24, "steps": 4,
                    "compare_rounds": 2},
        "limits": _TEST_LIMITS},
    "granite-3-2b.serve_prefill_4k": {
        "port_config": _DENSE,
        "traffic": {"batch": 2, "prompt_len": 16, "gen": 4,
                    "compare_batches": 2},
        "limits": _TEST_LIMITS},
}


def run_small(workload: str, seed: int = 2 ** 40 + 3, trace: bool = False,
              seconds: float = 0.2) -> dict:
    """One run of ``workload`` at its test size on the CPU, the look for a
    chip skipped."""
    from perfbench.lib.runner import run_cell
    return run_cell(workload, seed, seconds, trace, t0=time.perf_counter(),
                    device="cpu", require_chip=False,
                    overrides=SMALL[workload])


@pytest.fixture
def card():
    """Skips a test on a machine without an NVIDIA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python -m pytest "
                    "perfbench/tests -m gpu on the card)")


@pytest.fixture(name="run_small")
def _run_small():
    return run_small


@pytest.fixture(name="small")
def _small():
    return SMALL
