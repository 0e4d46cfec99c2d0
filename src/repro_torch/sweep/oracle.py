"""Dispatch-time config oracle: "best config for a shape nobody tuned".

After a sweep campaign, a dispatch site holds a concrete problem shape —
usually *not* one of the tuned grid points — and needs a configuration
now, without measuring anything. :class:`ConfigOracle` answers from the
campaign's trial cache with two regimes:

  * **warm** (``source="model"``): a surrogate fit on every cached trial,
    jointly encoded as shape×config features, is evaluated over the whole
    config space *at the query shape's features*; the best predicted mean
    wins. Because numeric shape features are continuous (log-position in
    the tuned range, :class:`~repro_torch.surrogate.encoding.SpaceEncoder`),
    an unseen shape between tuned grid points genuinely interpolates.
  * **cold** (``source="nearest:<shape_key>"``): with too little data to
    trust a joint fit, the oracle returns the incumbent of the most
    trustworthy tuned shape. Trustworthiness mirrors the transfer-tuning
    donor ranking (``TrialCache.rank_donors``): tuned shapes whose scores
    *rank* shared configs the way the query shape's own cached trials do
    (if it has any) are Spearman-ordered first; the rest order by
    shape-feature distance — nearest tuned shape wins.

Both regimes answer from cache only: the oracle never measures.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Union

import numpy as np

from ..core.cache import CachedTrial, TrialCache, config_key
from ..core.confidence import spearman
from ..core.evaluator import EvalResult
from ..core.searchspace import Config, SearchSpace
from ..core.stop_conditions import Direction
from ..surrogate.encoding import SpaceEncoder
from ..surrogate.model import make_surrogate, poly_dim

from .shapes import SHAPE_SEP, shape_key, split_benchmark_name

__all__ = ["ConfigOracle", "OracleAnswer"]


@dataclasses.dataclass(frozen=True)
class OracleAnswer:
    """One dispatch decision and where it came from."""

    shape: Config
    config: Config
    source: str                    # "model" | "nearest:<shape_key>"
    predicted: Optional[float]     # model: predicted mean at (shape, config);
                                   # nearest: the donor incumbent's score
    donor: Optional[Config] = None  # the tuned shape answering a cold query

    @property
    def cold(self) -> bool:
        return self.source != "model"


class ConfigOracle:
    """Answers ``best_for(shape)`` from a sweep campaign's trial cache.

    ``cache`` is a fingerprint-filtered :class:`~repro_torch.core.cache.TrialCache`
    (scores never transfer across machines) or an iterable of
    :class:`~repro_torch.core.cache.CachedTrial` — tests and offline analysis
    feed trial lists directly. Only benchmarks named
    ``"<base>@<shape_key>"`` participate. ``min_shapes`` gates the warm
    regime: a joint surface fit on a single tuned shape has no shape
    gradient to interpolate with, so at least two distinct shapes (and,
    for the ridge model, at least ``poly_dim(dim)`` trials) are required
    before the model answers; anything less falls back to the nearest
    tuned incumbent.
    """

    def __init__(self, config_space: SearchSpace, shape_space: SearchSpace,
                 cache: Union[TrialCache, Iterable[CachedTrial]],
                 base: str, direction: Direction = Direction.MAXIMIZE,
                 model: str = "ridge", min_shapes: int = 2):
        if min_shapes < 1:
            raise ValueError(f"min_shapes must be >= 1, got {min_shapes}")
        self.config_space = config_space
        self.shape_space = shape_space
        self.base = base
        self.direction = direction
        self.model = model
        self.min_shapes = min_shapes
        self.encoder = SpaceEncoder(config_space, shape_space=shape_space)
        self._configs = config_space.ordered("exhaustive")
        trials = cache.trials() if isinstance(cache, TrialCache) else cache
        prefix = base + SHAPE_SEP
        self._shapes: dict[str, Config] = {}
        self._by_shape: dict[str, list[tuple[Config, EvalResult]]] = {}
        self.n_trials = 0
        for t in trials:
            if not t.benchmark.startswith(prefix):
                continue
            _, shape = split_benchmark_name(t.benchmark)
            if shape is None:
                continue
            key = shape_key(shape)
            self._shapes.setdefault(key, shape)
            self._by_shape.setdefault(key, []).append((t.config, t.result))
            self.n_trials += 1
        self._surrogate = None

    # -- warm regime ---------------------------------------------------------
    @property
    def tuned_shapes(self) -> list[Config]:
        """Shapes with at least one cached trial, key order."""
        return [self._shapes[k] for k in sorted(self._shapes)]

    def is_warm(self) -> bool:
        """True when the joint model has enough data to answer."""
        if len(self._shapes) < self.min_shapes:
            return False
        if self.model == "ridge":
            return self.n_trials >= poly_dim(self.encoder.dim)
        return self.n_trials > 0

    def _fit(self):
        if self._surrogate is None:
            surrogate = make_surrogate(self.model, self.encoder.dim,
                                       len(self._configs))
            # pruned trials feed the fit too — truncated means are
            # unbiased, and dropping them would starve the model exactly
            # where stop-condition-4 campaigns produce the most records
            for key, pool in sorted(self._by_shape.items()):
                shape = self._shapes[key]
                for cfg, res in pool:
                    surrogate.observe(self.encoder.encode(cfg, shape=shape),
                                      float(res.score))
            self._surrogate = surrogate
        return self._surrogate

    def predict(self, shape: Config) -> list[tuple[Config, float]]:
        """Every config's predicted mean at ``shape``, best first —
        the warm regime's full ranking (for dashboards/CLI)."""
        X = self.encoder.encode_all(self._configs, shape=shape)
        mean, _ = self._fit().predict(X)
        order = np.lexsort((np.arange(len(mean)),
                            -mean if self.direction is Direction.MAXIMIZE
                            else mean))
        return [(self._configs[int(i)], float(mean[int(i)])) for i in order]

    # -- cold regime ---------------------------------------------------------
    def rank_shapes(self, shape: Config, min_overlap: int = 3,
                    ) -> list[tuple[str, Optional[float]]]:
        """Tuned shapes as fallback donors, most trustworthy first —
        the donor-ranking rule of ``TrialCache.rank_donors`` transplanted
        from fingerprints to shapes. Donors sharing at least
        ``min_overlap`` unpruned configs with the query shape's *own*
        cached trials (a partially-tuned query) are Spearman-ordered by
        shared-config score correlation; the rest order by distance in
        normalized shape-feature space. Returns ``(shape_key, rho)``
        pairs, ``rho=None`` for the distance-ordered tail."""
        own_key = shape_key(shape)
        own = {config_key(cfg): float(res.score)
               for cfg, res in self._by_shape.get(own_key, ())
               if not res.pruned}
        target = self.encoder.shape_features(shape)
        correlated: list[tuple[str, float, float]] = []
        uncorrelated: list[tuple[str, float]] = []
        for key in sorted(self._shapes):
            if key == own_key:
                continue
            donor = {config_key(cfg): float(res.score)
                     for cfg, res in self._by_shape[key]
                     if not res.pruned}
            dist = float(np.linalg.norm(
                self.encoder.shape_features(self._shapes[key]) - target))
            shared = sorted(set(donor) & set(own))
            rho = (spearman([own[k] for k in shared],
                            [donor[k] for k in shared])
                   if len(shared) >= min_overlap else None)
            if rho is None:
                uncorrelated.append((key, dist))
            else:
                correlated.append((key, rho, dist))
        correlated.sort(key=lambda krd: (-krd[1], krd[2], krd[0]))
        uncorrelated.sort(key=lambda kd: (kd[1], kd[0]))
        return ([(k, rho) for k, rho, _ in correlated]
                + [(k, None) for k, _ in uncorrelated])

    def _incumbent(self, key: str) -> Optional[tuple[Config, float]]:
        best: Optional[tuple[Config, float]] = None
        for cfg, res in self._by_shape.get(key, ()):
            if res.pruned:
                continue
            if best is None or self.direction.better(res.score, best[1]):
                best = (cfg, float(res.score))
        return best

    # -- the dispatch call ---------------------------------------------------
    def best_for(self, shape: Config) -> OracleAnswer:
        """The configuration to dispatch for ``shape``. Warm: joint-model
        argbest. Cold: nearest tuned shape's incumbent. Raises
        ``LookupError`` when the cache holds nothing usable."""
        missing = [p.name for p in self.shape_space.params
                   if p.name not in shape]
        if missing:
            raise KeyError(f"shape {dict(shape)!r} missing parameters "
                           f"{missing}")
        if self.is_warm():
            ranked = self.predict(shape)
            cfg, mean = ranked[0]
            return OracleAnswer(shape=dict(shape), config=dict(cfg),
                                source="model", predicted=mean)
        # cold: a directly-tuned query shape answers with its own
        # incumbent (distance zero beats every donor), then donors in
        # trust order
        own = shape_key(shape)
        for key, _rho in [(own, None)] + self.rank_shapes(shape):
            inc = self._incumbent(key)
            if inc is not None:
                return OracleAnswer(shape=dict(shape), config=dict(inc[0]),
                                    source=f"nearest:{key}",
                                    predicted=inc[1],
                                    donor=dict(self._shapes[key]))
        raise LookupError(f"no unpruned trials under base {self.base!r} — "
                          "run a campaign first")
