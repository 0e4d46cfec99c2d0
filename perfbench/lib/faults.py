"""Faults planted in the port, underneath a run's timed path, to read
what the check of ``correct`` makes of them: the CPU tests plant them
at a cell's test size, and ``perfbench/control.py --fault state`` reads
one at a cell's own size on the chip. The benchmark's own runs plant none."""

from __future__ import annotations

import contextlib
from typing import Iterator

__all__ = ["state_unchanged"]


@contextlib.contextmanager
def state_unchanged() -> Iterator[None]:
    """Every decode step reads the cache it was given and hands it back
    unchanged: its writes land in a copy."""
    from repro_torch.models import api
    real = api.decode_fn

    def broken(params, batch, cache, pos, cfg, step):
        copy = {k: ({kk: vv.clone() for kk, vv in v.items()}
                    if isinstance(v, dict) else v.clone())
                for k, v in cache.items()}
        logits, _ = real(params, batch, copy, pos, cfg, step)
        return logits, cache

    api.decode_fn = broken
    try:
        yield
    finally:
        api.decode_fn = real
