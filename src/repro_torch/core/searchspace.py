"""Declarative search spaces with constraint specification (paper Sec. IV).

The paper stresses that "the definition and reduction of the search space is
critical for autotuning" and walks through an explicit cardinality reduction
for DGEMM: |S| = 7*7*11 = 539 (powers of two) -> narrowed ranges ->
4*4*6 = 96, with leading dimensions adjusted to multiples of 2 (500, 1000,
2000, 4000) per Intel's MKL guidance. This module makes those manipulations
first-class: spaces are declarative, constraints are explicit predicates, and
cardinality is always reportable.
"""

from __future__ import annotations

import dataclasses
import itertools
import numbers
import random as _random
from typing import Any, Callable, Iterator, Mapping, Optional, Sequence

Config = dict[str, Any]
Constraint = Callable[[Config], bool]


@dataclasses.dataclass(frozen=True)
class Param:
    """One discrete tunable with an ordered value domain."""

    name: str
    values: tuple

    def __post_init__(self):
        if len(self.values) == 0:
            raise ValueError(f"param {self.name!r} has an empty domain")
        if len(set(self.values)) != len(self.values):
            raise ValueError(f"param {self.name!r} has duplicate values")

    @property
    def cardinality(self) -> int:
        return len(self.values)


def param(name: str, values: Sequence) -> Param:
    return Param(name=name, values=tuple(values))


def powers_of_two(lo: int, hi: int) -> tuple[int, ...]:
    """Inclusive power-of-two ladder, e.g. (64, 128, ..., 4096)."""
    out = []
    v = 1
    while v < lo:
        v *= 2
    while v <= hi:
        out.append(v)
        v *= 2
    return tuple(out)


def doubling_from(start: int, hi: int) -> tuple[int, ...]:
    """Doubling ladder from an arbitrary start: 500, 1000, 2000, 4000 — the
    paper's multiple-of-2 leading-dimension adjustment."""
    out = []
    v = start
    while v <= hi:
        out.append(v)
        v *= 2
    return tuple(out)


class SearchSpace:
    """Cartesian product of :class:`Param` domains filtered by constraints."""

    def __init__(self, params: Sequence[Param],
                 constraints: Sequence[Constraint] = ()):
        names = [p.name for p in params]
        if len(set(names)) != len(names):
            raise ValueError("duplicate parameter names")
        self.params = tuple(params)
        self.constraints = tuple(constraints)
        self._cardinality: Optional[int] = None   # filtered-count cache

    # -- construction helpers -------------------------------------------------
    def constrain(self, *constraints: Constraint) -> "SearchSpace":
        """Return a new space with additional constraints (paper's
        'constraint specification')."""
        return SearchSpace(self.params, self.constraints + tuple(constraints))

    def narrow(self, **bounds: tuple) -> "SearchSpace":
        """Return a new space with some parameter domains replaced — the
        paper's range-narrowing reduction (e.g. n: 64..4096 -> 512..4096)."""
        by_name = {p.name: p for p in self.params}
        for name, values in bounds.items():
            if name not in by_name:
                raise KeyError(name)
            by_name[name] = param(name, values)
        return SearchSpace(tuple(by_name.values()), self.constraints)

    # -- enumeration ----------------------------------------------------------
    @property
    def names(self) -> tuple[str, ...]:
        """Parameter names in declaration order."""
        return tuple(p.name for p in self.params)

    @property
    def raw_cardinality(self) -> int:
        """|S| before constraint filtering (the paper's Eq. 8 number)."""
        n = 1
        for p in self.params:
            n *= p.cardinality
        return n

    @property
    def cardinality(self) -> int:
        """|S| after constraint filtering. Enumerative — the paper's premise
        is that autotuning-benchmark spaces are deliberately low-cardinality
        — but computed once: params/constraints are immutable, and reports
        read this per render."""
        if self._cardinality is None:
            self._cardinality = sum(1 for _ in self.configs())
        return self._cardinality

    def _satisfies(self, cfg: Config) -> bool:
        return all(c(cfg) for c in self.constraints)

    def satisfies(self, cfg: Config) -> bool:
        """True iff ``cfg`` passes every constraint predicate (domain
        membership is *not* checked; see ``__contains__`` for both)."""
        return self._satisfies(cfg)

    def __contains__(self, cfg: object) -> bool:
        """True iff ``cfg`` assigns every parameter a value from its domain
        and satisfies all constraints."""
        if not isinstance(cfg, Mapping):
            return False
        if set(cfg) != {p.name for p in self.params}:
            return False
        if any(cfg[p.name] not in p.values for p in self.params):
            return False
        return self._satisfies(dict(cfg))

    def project(self, cfg: Mapping) -> Optional[Config]:
        """Nearest in-space configuration — the transfer-tuning seed
        projection. Parameters present in ``cfg`` keep their value when it
        is in the domain, snap to the numerically nearest domain value
        otherwise; missing or non-numeric mismatches fall back to the
        domain's first value. Returns ``None`` when the projection
        violates a constraint (the seed is unusable here)."""
        out: Config = {}
        for p in self.params:
            v = cfg.get(p.name)
            if v in p.values:
                out[p.name] = v
                continue
            numeric = (isinstance(v, numbers.Real)
                       and not isinstance(v, bool)
                       and all(isinstance(d, numbers.Real)
                               and not isinstance(d, bool)
                               for d in p.values))
            out[p.name] = min(p.values, key=lambda d: abs(d - v)) \
                if numeric else p.values[0]
        return out if self._satisfies(out) else None

    def configs(self) -> Iterator[Config]:
        """Canonical (row-major) enumeration order."""
        names = [p.name for p in self.params]
        for combo in itertools.product(*[p.values for p in self.params]):
            cfg = dict(zip(names, combo))
            if self._satisfies(cfg):
                yield cfg

    def ordered(self, order: str = "exhaustive",
                seed: Optional[int] = None) -> list[Config]:
        """Materialized search order.

        ``exhaustive``: canonical order; ``reverse``: the paper's "R"
        ablation (large/slow configurations first — stresses how pruning
        effectiveness depends on when a good incumbent is found);
        ``random``: seeded shuffle.
        """
        cfgs = list(self.configs())
        if order == "exhaustive":
            return cfgs
        if order == "reverse":
            return cfgs[::-1]
        if order == "random":
            rng = _random.Random(seed if seed is not None else 0)
            rng.shuffle(cfgs)
            return cfgs
        raise ValueError(f"unknown order {order!r}")

    def __repr__(self) -> str:
        doms = ", ".join(f"{p.name}[{p.cardinality}]" for p in self.params)
        return (f"SearchSpace({doms}, raw={self.raw_cardinality}, "
                f"constraints={len(self.constraints)})")


def grid(**domains: Sequence) -> SearchSpace:
    """Shorthand: ``grid(n=(1, 2), m=(3, 4))``."""
    return SearchSpace([param(k, v) for k, v in domains.items()])
