"""Launch counts of the kernel wrappers.

Each wrapper calls :func:`count_launch` where it launches its kernel and
nowhere else. The counts are kernel executions: a launch into a stream
that a CUDA graph is capturing (:mod:`repro_torch.graphs`) runs nothing,
so it goes into the open capture's record instead (whichever thread
issues it: the autograd engine runs a backward pass on a thread of its
own), and the graph adds its record with :func:`add` at every replay.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

import torch

__all__ = ["add", "count_launch", "recording"]

_LOCK = threading.Lock()
#: the open capture's record (one at a time: captures hold a lock)
_RECORDS: list = []


def count_launch(wrapper, route: Optional[str] = None) -> None:
    """One launch of ``wrapper``'s kernel (on ``route``, for a wrapper
    that counts its launches per route)."""
    if _RECORDS and torch.cuda.is_current_stream_capturing():
        _RECORDS[-1].append((wrapper, route))
        return
    add([(wrapper, route)])


@contextlib.contextmanager
def recording() -> Iterator[list]:
    """The launches captured inside the block, as ``(wrapper, route)``."""
    record: list = []
    _RECORDS.append(record)
    try:
        yield record
    finally:
        _RECORDS.remove(record)


def add(launches: list) -> None:
    """One more launch of each ``(wrapper, route)`` in ``launches``."""
    with _LOCK:
        for wrapper, route in launches:
            wrapper.launches += 1
            if route is not None:
                wrapper.route_launches[route] += 1
