"""Canonical shape keys: how a problem shape names its cache namespace.

A sweep campaign tunes one benchmark *family* across a grid of problem
shapes. Each shape gets its own benchmark name in the shared trial cache
and run ledger — ``"<base>@<shape_key>"`` — so per-shape warm starts,
incumbents, and history series stay isolated (the cache already keys
everything by benchmark name) while one file still holds the whole
campaign. The key is a sorted ``name=value`` join, order-insensitive like
:func:`repro_torch.core.cache.config_key` but readable in dashboards:
``dgemm@m=512,n=1024``.

Values round-trip through ``int`` → ``float`` → ``str`` on parse, which
covers every domain the search-space layer produces; string values must
not contain the separators (enforced at key time, not parse time).
"""

from __future__ import annotations

from typing import Optional

from ..core.searchspace import Config

__all__ = ["SHAPE_SEP", "parse_shape_key", "shape_benchmark_name",
           "shape_key", "split_benchmark_name"]

#: separates the family base name from the shape key in benchmark names
SHAPE_SEP = "@"


def shape_key(shape: Config) -> str:
    """Canonical, order-insensitive key of one shape: ``"k=64,m=512"``."""
    parts = []
    for name in sorted(shape):
        v = shape[name]
        text = f"{v}"
        if any(sep in f"{name}{text}" for sep in (",", "=", SHAPE_SEP)):
            raise ValueError(f"shape entry {name}={v!r} contains a "
                             "reserved separator")
        parts.append(f"{name}={text}")
    if not parts:
        raise ValueError("empty shape")
    return ",".join(parts)


def _parse_value(raw: str):
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            continue
    return raw


def parse_shape_key(key: str) -> Config:
    """Inverse of :func:`shape_key` (up to numeric formatting)."""
    shape: Config = {}
    for part in key.split(","):
        name, sep, raw = part.partition("=")
        if not sep or not name:
            raise ValueError(f"malformed shape key {key!r}")
        shape[name] = _parse_value(raw)
    return shape


def shape_benchmark_name(base: str, shape: Config) -> str:
    """The cache/ledger benchmark name of one swept shape."""
    if SHAPE_SEP in base:
        raise ValueError(f"base name {base!r} contains {SHAPE_SEP!r}")
    return f"{base}{SHAPE_SEP}{shape_key(shape)}"


def split_benchmark_name(name: str) -> tuple[str, Optional[Config]]:
    """(base, shape) of a benchmark name; shape is ``None`` for plain
    (non-sweep) names."""
    base, sep, key = name.partition(SHAPE_SEP)
    if not sep:
        return name, None
    return base, parse_shape_key(key)
