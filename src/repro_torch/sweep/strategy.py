"""Shape-conditioned surrogate search: one model, many shapes.

:class:`SweepStrategy` is :class:`~repro_torch.surrogate.strategy.SurrogateStrategy`
pointed at the joint shape×config surface. Three things change, all through
the base class's subclass hooks — the ask/tell mechanics, acquisition, and
pruning-aware incumbent tracking are inherited untouched:

  * the encoder is built over ``(config_space, shape_space)``, so every
    feature vector carries the shape being tuned (a fixed block within one
    run) next to the config levels;
  * cached trials of *sibling* shapes — same campaign, same hardware
    fingerprint — are fed to the surrogate as prior observations at reset,
    so the model starts already knowing the surface's shape-trend and the
    default initial design shrinks from space-filling to a two-point
    anchor;
  * the default surrogate is ``"ridge"`` rather than ``"auto"``: the
    quadratic feature expansion carries shape×config cross terms, which is
    what lets knowledge transfer across shapes (k-NN would need the tiny
    per-shape pool to stand alone).

Attribution: ``name = "sweep"``, so every trial record in the cache and
every ledger record carries ``strategy="sweep"``.
"""

from __future__ import annotations

from typing import Iterable, Optional

from ..core.searchspace import Config, SearchSpace
from ..surrogate.encoding import SpaceEncoder
from ..surrogate.strategy import SurrogateStrategy

__all__ = ["SweepStrategy"]

#: one prior observation: (shape, config, score) of a cached sibling trial
Prior = tuple[Config, Config, float]


class SweepStrategy(SurrogateStrategy):
    """Surrogate search over one shape of a sweep campaign.

    ``shape`` is the fixed problem shape this run tunes (its features are
    appended to every encoded config); ``shape_space`` declares the
    campaign grid the features normalize against. ``priors`` are
    ``(shape, config, score)`` triples from sibling shapes' cached trials
    — pass trials measured under the *same hardware fingerprint* only
    (scores never transfer across machines; the campaign runner reads
    them from a fingerprint-filtered :class:`~repro_torch.core.cache.TrialCache`).
    Remaining arguments are inherited from
    :class:`~repro_torch.surrogate.strategy.SurrogateStrategy`.
    """

    name = "sweep"

    def __init__(self, shape: Config, shape_space: SearchSpace,
                 priors: Iterable[Prior] = (),
                 budget: Optional[int] = None,
                 n_init: Optional[int] = None,
                 batch: Optional[int] = None,
                 model: str = "ridge", acquisition: str = "ei",
                 seed: Optional[int] = None):
        super().__init__(budget=budget, n_init=n_init, batch=batch,
                         model=model, acquisition=acquisition, seed=seed)
        missing = [p.name for p in shape_space.params if p.name not in shape]
        if missing:
            raise KeyError(f"shape {dict(shape)!r} missing parameters "
                           f"{missing}")
        self.shape = dict(shape)
        self.shape_space = shape_space
        self.priors = tuple(priors)

    def _make_encoder(self, space: SearchSpace) -> SpaceEncoder:
        return SpaceEncoder(space, shape_space=self.shape_space)

    def _encode(self, config: Config):
        return self._encoder.encode(config, shape=self.shape)

    def _prior_observations(self):
        for shape, config, score in self.priors:
            try:
                x = self._encoder.encode(config, shape=shape)
            except KeyError:
                # a sibling trial from outside this config space (e.g. the
                # campaign's space was narrowed since) cannot be encoded —
                # drop it rather than poison the model
                continue
            yield x, float(score)
