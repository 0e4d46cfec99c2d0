"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the port at the cell's test size
on the CPU (the look for a chip skipped, the rest of a run driven as on
the chip). The faults: an answer or a token altered where it is
produced; half of the batch left out (the rest's results stand in for
it); a step that returns its state unchanged. No cell exchanges data
between chips."""

import pytest
import torch

TUNE = "granite-3-2b.tune_gemm_f32"
DECODE = "granite-3-2b.serve_decode_32k"
PREFILL = ["granite-3-2b.serve_prefill_4k"]


def _patch_matmul(monkeypatch, fault):
    from repro_torch.bench import common
    real = common.matmul

    def broken(a, b, **kw):
        return fault(real(a, b, **kw).clone())
    monkeypatch.setattr(common, "matmul", broken)


def _altered(c):
    c[0, 0] += 1.0
    return c


def _half_rows(c):
    c[c.shape[0] // 2:] = 0.0
    return c


@pytest.mark.parametrize("fault", [_altered, _half_rows])
def test_gemm_faults(fault, monkeypatch, run_small):
    _patch_matmul(monkeypatch, fault)
    out = run_small(TUNE)
    assert not out["correct"], out["checks"]


def _patch_entry(monkeypatch, name, wrap):
    from repro_torch.launch import serve
    monkeypatch.setattr(serve, name, wrap(getattr(serve, name)))


def _token_altered(fn):
    def broken(*args, **kw):
        out = fn(*args, **kw)
        out["tokens"][0, -1] = (out["tokens"][0, -1] + 1) % 512
        return out
    return broken


def _half_batch_generate(fn):
    def broken(params, prompt, *args, **kw):
        half = prompt.shape[0] // 2
        out = fn(params, prompt[:half], *args, **kw)
        for key in ("tokens", "logits"):
            out[key] = torch.cat([out[key], out[key]])
        return out
    return broken


def _half_batch_decode(fn):
    def broken(params, logits, cache, *args, **kw):
        half = logits.shape[0] // 2
        logits = torch.cat([logits[:half], logits[:half]])
        return fn(params, logits, cache, *args, **kw)
    return broken


def _run(fault, workload, run_small):
    """``workload`` at its test size with ``fault`` planted (a callable
    that patches the port, or "state": ``faults.state_unchanged``)."""
    from perfbench.lib import faults
    if fault == "state":
        with faults.state_unchanged():
            return run_small(workload)
    fault()
    return run_small(workload)


@pytest.mark.parametrize("workload", PREFILL)
@pytest.mark.parametrize("fault", ["token", "half_batch", "state"])
def test_generate_faults(workload, fault, monkeypatch, run_small):
    plant = {"token": lambda: _patch_entry(monkeypatch, "generate",
                                           _token_altered),
             "half_batch": lambda: _patch_entry(monkeypatch, "generate",
                                                _half_batch_generate),
             "state": "state"}[fault]
    out = _run(plant, workload, run_small)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["token", "half_batch", "state"])
def test_decode_faults(fault, monkeypatch, run_small):
    plant = {"token": lambda: _patch_entry(monkeypatch, "greedy_decode",
                                           _token_altered),
             "half_batch": lambda: _patch_entry(monkeypatch, "greedy_decode",
                                                _half_batch_decode),
             "state": "state"}[fault]
    out = _run(plant, DECODE, run_small)
    assert not out["correct"], out["checks"]
