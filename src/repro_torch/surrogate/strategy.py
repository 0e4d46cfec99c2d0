"""Model-guided search strategies on the ask/tell protocol.

The paper cuts search cost by *reducing the space* and *terminating
evaluations early*; every strategy the repo shipped before this module
still proposes configurations blindly. "From Roofline to Ruggedness"
shows GEMM landscapes are rugged enough that proposal order matters, and
the kernel-tuner benchmarking suite literature treats Bayesian/bandit
searchers as the baseline competitive tuners. These two strategies close
that gap — through the same :class:`~repro_torch.core.tuner.Tuner` engine,
backends, cache, and transfer plumbing as every other strategy (the
engine needed no changes; that is what the ask/tell layer is for):

  * :class:`SurrogateStrategy` — fit a surrogate
    (:mod:`~repro_torch.surrogate.model`) to observed scores, rank unevaluated
    configurations by acquisition (:mod:`~repro_torch.surrogate.acquisition`),
    propose the top-k, update the model on every ``tell``. Warm-start
    seeds (``TrialCache.suggest_seeds`` → ``Tuner.tune(seeds=...)``)
    are evaluated first and become the model's first observations.
  * :class:`BanditStrategy` — Thompson-style sampling over
    parameter-level arms: each (param, value) pair keeps Welford moments
    of the scores of configurations containing it, and proposals compose
    a config by drawing one posterior sample per arm and taking each
    parameter's best draw. Never enumerates the space — the policy for
    cardinalities where even materializing the config list is off-budget.

Both are deterministic under a fixed seed (numpy ``default_rng``; no
wall-clock anywhere), so cached reruns and golden tests stay honest. The
port keeps numpy's generators rather than torch's: the same seed and
space propose the same sequence as the JAX package's strategies.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core import welford
from ..core.cache import config_key
from ..core.evaluator import EvalResult, EvaluationSettings
from ..core.executor import Batch
from ..core.searchspace import Config, SearchSpace
from ..core.stop_conditions import Direction
from ..core.strategy import SearchStrategy
from ..core.welford import WelfordState

from .acquisition import (expected_improvement, noise_adjusted_best,
                          upper_confidence_bound)
from .encoding import SpaceEncoder
from .model import make_surrogate

__all__ = ["BanditStrategy", "SurrogateStrategy"]


def _pooled_state(result: EvalResult) -> WelfordState:
    """The trial's sample stream as one WelfordState (exact Chan merge of
    the stored per-invocation moments — same pooling the ledger uses)."""
    return welford.tree_merge([
        WelfordState(count=float(i.count), mean=i.mean, m2=i.m2)
        for i in result.invocations])


class SurrogateStrategy(SearchStrategy):
    """Surrogate-guided proposal order: ask = top-k acquisition over the
    unevaluated configurations, tell = incremental model update.

    ``budget`` caps proposals (``None`` — run until the space is
    exhausted: the model then only *orders* the sweep, which still pays
    off because a good incumbent found early tightens stop-condition-4
    pruning for everything after it). ``n_init`` seeds the model with a
    space-filling random sample before acquisition takes over (default:
    enough points to make the default surrogate identifiable, at least
    3). ``batch`` is the proposal width when the backend imposes no round
    structure (``ask(None)``); round-synchronized backends get their own
    round width. ``model`` picks the surrogate ("auto" | "ridge" |
    "knn"), ``acquisition`` the scoring rule ("ei" | "ucb") — EI measures
    improvement against the incumbent's own CI bound, UCB is optimism at
    the settings' confidence level (see :mod:`~repro_torch.surrogate.acquisition`).
    """

    name = "surrogate"

    def __init__(self, budget: Optional[int] = None,
                 n_init: Optional[int] = None,
                 batch: Optional[int] = None,
                 model: str = "auto", acquisition: str = "ei",
                 seed: Optional[int] = None):
        if budget is not None and budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        if n_init is not None and n_init < 1:
            raise ValueError(f"n_init must be >= 1, got {n_init}")
        if batch is not None and batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if acquisition not in ("ei", "ucb"):
            raise ValueError(f"unknown acquisition {acquisition!r} "
                             "(ei | ucb)")
        self.budget = budget
        self.n_init = n_init
        self.batch = batch
        self.model = model
        self.acquisition = acquisition
        self.seed = seed

    # -- subclass hooks (the sweep layer re-targets these) -------------------
    def _make_encoder(self, space: SearchSpace) -> SpaceEncoder:
        """The feature encoder ``reset`` installs. Subclasses may return
        an encoder over a *wider* feature space (e.g. joint shape×config,
        :class:`~repro_torch.sweep.strategy.SweepStrategy`) as long as
        :meth:`_encode` agrees with it."""
        return SpaceEncoder(space)

    def _encode(self, config: Config) -> np.ndarray:
        """Feature vector of one config under the installed encoder."""
        return self._encoder.encode(config)

    def _prior_observations(self):
        """(x, y) pairs fed to the surrogate at reset, before any trial of
        this run — empty by default. Subclasses yield transfer knowledge
        here (cached trials of sibling shapes under the same hardware
        fingerprint); a warmed model skips the random-exploration phase
        and shrinks the default initial design to a local anchor."""
        return ()

    def reset(self, space: SearchSpace, settings: EvaluationSettings,
              seeds: Sequence[Config] = ()) -> None:
        self._direction: Direction = settings.direction
        self._confidence = settings.confidence
        self._xi = settings.rel_margin
        self._encoder = self._make_encoder(space)
        self._configs = space.ordered("exhaustive")
        self._X = (np.stack([self._encode(c) for c in self._configs])
                   if self._configs
                   else np.zeros((0, self._encoder.dim), dtype=np.float64))
        self._index = {config_key(c): i for i, c in enumerate(self._configs)}
        self._surrogate = make_surrogate(self.model, self._encoder.dim,
                                         len(self._configs))
        priors = list(self._prior_observations())
        if priors:
            self._surrogate.observe_many(
                np.stack([x for x, _ in priors]), [y for _, y in priors])
        self._n_priors = len(priors)
        self._rng = np.random.default_rng(
            self.seed if self.seed is not None else 0)
        self._unproposed = set(range(len(self._configs)))
        self._proposed = 0
        self._best: Optional[tuple[float, WelfordState]] = None
        self._done = not self._configs

        # initial design: seeds first (deduplicated), then a random
        # space-filling sample
        seed_idx: list[int] = []
        seen: set[int] = set()
        for cfg in seeds:
            i = self._index.get(config_key(cfg))
            if i is not None and i not in seen:
                seen.add(i)
                seed_idx.append(i)
        if self.n_init is not None:
            want = self.n_init
        elif self._n_priors:
            # the priors already identify the model: two fresh anchor
            # points re-ground it in this run's own measurements and the
            # acquisition takes over
            want = 2
        else:
            want = max(3, 2 * self._encoder.dim + 1)
        pool = sorted(self._unproposed - seen)
        fill = max(0, want - len(seed_idx))
        if fill and pool:
            picks = self._rng.choice(len(pool), size=min(fill, len(pool)),
                                     replace=False)
            seed_idx.extend(pool[int(i)] for i in sorted(picks))
        self._init_queue = seed_idx

    def _budget_left(self) -> Optional[int]:
        return None if self.budget is None else self.budget - self._proposed

    def _take(self, idx: list[int]) -> Optional[Batch]:
        if not idx:
            return None
        self._unproposed.difference_update(idx)
        self._proposed += len(idx)
        return Batch(tuple(self._configs[i] for i in idx))

    def _width(self, n: Optional[int]) -> int:
        width = n if n else (self.batch or 1)
        left = self._budget_left()
        if left is not None:
            width = min(width, left)
        return min(width, len(self._unproposed))

    def ask(self, n: Optional[int]) -> Optional[Batch]:
        if self._done:
            return None
        left = self._budget_left()
        if (left is not None and left <= 0) or not self._unproposed:
            self._done = True
            return None
        k = self._width(n)
        if k < 1:
            self._done = True
            return None
        if self._init_queue:
            take = [i for i in self._init_queue[:k] if i in self._unproposed]
            del self._init_queue[:k]
            if take:
                return self._take(take)
            # every queued init config was already proposed — fall through
        if self._surrogate.n_observed == 0:
            # nothing to model yet (e.g. every outcome so far was pruned):
            # keep exploring at random rather than ranking on the prior
            pool = sorted(self._unproposed)
            picks = self._rng.choice(len(pool), size=min(k, len(pool)),
                                     replace=False)
            return self._take([pool[int(i)] for i in sorted(picks)])
        pool = sorted(self._unproposed)
        mean, std = self._surrogate.predict(self._X[pool])
        if self.acquisition == "ucb":
            scores = upper_confidence_bound(mean, std, self._direction,
                                            confidence=self._confidence)
        else:
            best = self._best_reference(float(np.max(mean))
                                        if self._direction is
                                        Direction.MAXIMIZE
                                        else float(np.min(mean)))
            scores = expected_improvement(mean, std, best, self._direction,
                                          xi=self._xi)
        order = np.lexsort((np.arange(len(pool)), -scores))
        return self._take([pool[int(i)] for i in order[:k]])

    def _best_reference(self, fallback: float) -> float:
        """EI's incumbent reference: the best observed trial's
        noise-adjusted CI bound; the surrogate's own best mean before any
        unpruned outcome exists."""
        if self._best is None:
            return fallback
        score, state = self._best
        if state.count >= 2:
            return noise_adjusted_best(state, self._confidence,
                                       self._direction)
        return score

    def tell(self, config: Config, result: EvalResult) -> None:
        i = self._index.get(config_key(config))
        if i is not None:
            self._unproposed.discard(i)   # cache-served outside our asks
        # Pruned trials feed the model too: a truncated stream's mean is an
        # unbiased (merely noisier) estimate, and under the paper's stop
        # condition 4 *most* trials are pruned — discarding them would
        # starve the surrogate. They are only barred from selection: a
        # truncated estimate never becomes the incumbent reference.
        x = self._X[i] if i is not None else self._encode(config)
        self._surrogate.observe(x, result.score)
        if result.pruned:
            return
        if self._best is None or self._direction.better(result.score,
                                                        self._best[0]):
            self._best = (result.score, _pooled_state(result))


class BanditStrategy(SearchStrategy):
    """Thompson-style sampling over parameter-level arms, for spaces too
    large to enumerate.

    Every (param, value) pair is an arm carrying Welford moments of the
    scores of configurations that used it. A proposal draws one posterior
    sample per arm — Normal(mean, s/√n) for played arms, an optimistic
    wide draw around the global mean for unplayed ones — and composes the
    configuration from each parameter's best draw, so information from
    every trial generalizes across the whole axis (the additive-effects
    assumption; cheap, and wrong in exactly the ways
    :class:`SurrogateStrategy`'s quadratic cross terms are not — pick per
    space size). Nothing here enumerates or materializes the space:
    memory is O(Σ|domain|), proposals are rejection-sampled against the
    constraints and the visited set.
    """

    name = "bandit"

    #: consecutive failed proposal draws before the strategy concludes the
    #: unvisited feasible space is (effectively) exhausted
    MAX_ATTEMPTS = 128

    def __init__(self, budget: Optional[int] = None,
                 batch: Optional[int] = None,
                 seed: Optional[int] = None):
        if budget is not None and budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        if batch is not None and batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.budget = budget
        self.batch = batch
        self.seed = seed

    def reset(self, space: SearchSpace, settings: EvaluationSettings,
              seeds: Sequence[Config] = ()) -> None:
        self._space = space
        self._direction = settings.direction
        self._rng = np.random.default_rng(
            self.seed if self.seed is not None else 0)
        self._arms: dict[tuple[str, object], WelfordState] = {}
        self._global = welford.init()
        self._visited: set[str] = set()
        self._proposed = 0
        self._done = False
        self._pending: list[Config] = []
        pending_keys: set[str] = set()
        for cfg in seeds:
            key = config_key(cfg)
            if key not in pending_keys:
                pending_keys.add(key)
                self._pending.append(cfg)

    def _budget_left(self) -> Optional[int]:
        return None if self.budget is None else self.budget - self._proposed

    def _draw_value(self, param, value) -> float:
        arm = self._arms.get((param.name, value))
        g_n = float(self._global.count)
        g_mean = float(self._global.mean) if g_n else 0.0
        g_std = float(self._global.std) if g_n >= 2 else 1.0
        g_std = g_std if g_std > 0 else 1.0
        if arm is None or arm.count < 1:
            # unplayed arm: optimistic wide draw around the global mean
            return g_mean + 2.0 * g_std * float(self._rng.standard_normal())
        n = float(arm.count)
        s = float(arm.std) if n >= 2 else g_std
        s = s if s > 0 else g_std
        return float(arm.mean) + (s / np.sqrt(n)) \
            * float(self._rng.standard_normal())

    def _compose(self) -> Optional[Config]:
        """One Thompson proposal; None when MAX_ATTEMPTS consecutive
        draws failed to produce a fresh feasible configuration."""
        maximize = self._direction is Direction.MAXIMIZE
        for attempt in range(self.MAX_ATTEMPTS):
            cfg: Config = {}
            for p in self._space.params:
                if attempt < self.MAX_ATTEMPTS // 2:
                    draws = [(self._draw_value(p, v), v) for v in p.values]
                    choose = max if maximize else min
                    pick = choose(draws, key=lambda dv: dv[0])[1]
                else:
                    # pure random tail: escape a constraint-locked or
                    # fully-visited Thompson mode
                    pick = p.values[int(self._rng.integers(len(p.values)))]
                cfg[p.name] = pick
            key = config_key(cfg)
            if key in self._visited or not self._space.satisfies(cfg):
                continue
            self._visited.add(key)   # reserve: proposed counts as visited
            return cfg
        return None

    def ask(self, n: Optional[int]) -> Optional[Batch]:
        if self._done:
            return None
        width = n if n else (self.batch or 1)
        left = self._budget_left()
        if left is not None:
            if left <= 0:
                self._done = True
                return None
            width = min(width, left)
        out: list[Config] = []
        while self._pending and len(out) < width:
            cfg = self._pending.pop(0)
            key = config_key(cfg)
            if key in self._visited:
                continue
            self._visited.add(key)
            out.append(cfg)
        while len(out) < width:
            cfg = self._compose()
            if cfg is None:
                break
            out.append(cfg)
        if not out:
            self._done = True
            return None
        self._proposed += len(out)
        return Batch(tuple(out))

    def tell(self, config: Config, result: EvalResult) -> None:
        self._visited.add(config_key(config))
        # pruned scores update the arms too (unbiased truncated estimates;
        # see SurrogateStrategy.tell) — they just never become incumbents
        y = float(result.score)
        self._global = welford.update(self._global, y)
        for p in self._space.params:
            v = config.get(p.name)
            arm = self._arms.get((p.name, v), welford.init())
            self._arms[(p.name, v)] = welford.update(arm, y)
