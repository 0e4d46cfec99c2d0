"""Seeds derived from a run's ``--seed``: one stream per purpose, so the
same seed gives the same operands, weights, prompts and samples, and a
purpose's draws do not move when another purpose draws more."""

from __future__ import annotations

import hashlib

__all__ = ["derive"]


def derive(seed: int, *tags: object) -> int:
    """A 63-bit seed for ``tags`` (a purpose and its indices) under the
    run's ``seed``, which may be any whole number."""
    text = ":".join([str(int(seed)), *map(str, tags)])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1
