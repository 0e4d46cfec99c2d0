"""Pure-numpy surrogate models with predictive uncertainty.

Two surrogates, one protocol (``observe`` / ``predict`` / ``n_observed``),
no dependencies beyond numpy:

  * :class:`BayesianRidgeSurrogate` — Bayesian linear regression on a
    degree-2 polynomial expansion of the encoded features, maintained
    *incrementally*: ``observe`` folds one (x, y) pair into the Gram
    sufficient statistics (Φᵀ Φ, Φᵀ y) in O(D²), and the posterior is
    solved lazily when ``predict`` is next called. Targets are
    standardized internally against the running Welford moments of the
    observed scores, so the prior/noise scales are unitless and one
    default works for GFLOP/s and GB/s objectives alike. The predictive
    variance ``σ²_noise + φᵀ S φ`` grows away from observed data — the
    uncertainty the acquisition functions spend.
  * :class:`KNNSurrogate` — distance-weighted k-nearest-neighbor
    regression. The fallback for tiny spaces, where a quadratic fit has
    more coefficients than the space has configurations: prediction is
    the inverse-distance-weighted mean of the k nearest observations, and
    the predictive std combines the neighbors' weighted spread with a
    term growing in the distance to the nearest neighbor (far from all
    data ⇒ uncertain), floored by the observed score spread so
    exploration never collapses prematurely.

:func:`make_surrogate` picks between them: ridge when the space is large
enough to support the quadratic fit, k-NN below that.

Numpy on the host, as in the JAX package, with the posterior covariance
from ``np.linalg.inv``: the same observations give the same predictions
to the last bit, so the same proposals (a torch solve would differ in the
last bits and could flip an acquisition argmax).
"""

from __future__ import annotations

import numpy as np

from ..core import welford

__all__ = ["BayesianRidgeSurrogate", "KNNSurrogate", "Surrogate",
           "make_surrogate", "poly_dim"]


def _poly_features(X: np.ndarray) -> np.ndarray:
    """Degree-2 polynomial expansion: [1, x_i, x_i·x_j (i ≤ j)]."""
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    n, d = X.shape
    cols = [np.ones((n, 1)), X]
    for i in range(d):
        cols.append(X[:, i:i + 1] * X[:, i:])
    return np.concatenate(cols, axis=1)


def poly_dim(dim: int) -> int:
    """Feature count of the degree-2 expansion over ``dim`` inputs."""
    return 1 + dim + dim * (dim + 1) // 2


class Surrogate:
    """The model protocol :class:`~repro_torch.surrogate.strategy.SurrogateStrategy`
    drives: feed outcomes with ``observe``, rank candidates with
    ``predict``."""

    name: str = "base"

    @property
    def n_observed(self) -> int:
        raise NotImplementedError

    def observe(self, x: np.ndarray, y: float) -> None:
        raise NotImplementedError

    def observe_many(self, X: np.ndarray, y) -> None:
        """Fold a batch of (x, y) pairs into the model — how prior
        observations (cached trials of sibling shapes, see
        :class:`~repro_torch.sweep.strategy.SweepStrategy`) warm a fresh
        surrogate before its first ask."""
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        for x, yi in zip(X, y):
            self.observe(x, float(yi))

    def predict(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(mean, std) per row of ``X``, in original target units."""
        raise NotImplementedError


class BayesianRidgeSurrogate(Surrogate):
    """Incremental Bayesian ridge regression on polynomial features.

    Posterior over weights w with prior N(0, α⁻¹I) and Gaussian noise
    precision β: S = (αI + β ΦᵀΦ)⁻¹, m = β S Φᵀt. Sufficient statistics
    accumulate per observation; the solve is deferred and cached until
    the next ``observe`` invalidates it. Standardization of targets is
    affine, so the standardized Gram vector Φᵀt is recovered exactly from
    the raw accumulators (Φᵀy, Σφ) and the running target moments — no
    replay of past observations is ever needed.
    """

    name = "ridge"

    def __init__(self, dim: int, alpha: float = 1e-2, noise: float = 1e-2):
        if alpha <= 0 or noise <= 0:
            raise ValueError("alpha and noise must be positive")
        self.dim = dim
        self.alpha = alpha
        self.noise = noise                   # σ²_noise in standardized units
        d = poly_dim(dim)
        self._gram = np.zeros((d, d))        # Φᵀ Φ
        self._phi_y = np.zeros(d)            # Φᵀ y  (raw targets)
        self._phi_sum = np.zeros(d)          # Σ φ   (for standardization)
        self._y_state = welford.init()
        self._posterior: tuple[np.ndarray, np.ndarray] | None = None

    @property
    def n_observed(self) -> int:
        return int(self._y_state.count)

    def observe(self, x: np.ndarray, y: float) -> None:
        phi = _poly_features(x)[0]
        self._gram += np.outer(phi, phi)
        self._phi_y += phi * float(y)
        self._phi_sum += phi
        self._y_state = welford.update(self._y_state, float(y))
        self._posterior = None

    def _y_scale(self) -> tuple[float, float]:
        mu = float(self._y_state.mean) if self.n_observed else 0.0
        sigma = float(self._y_state.std) if self.n_observed >= 2 else 0.0
        return mu, (sigma if sigma > 0 else 1.0)

    def _solve(self) -> tuple[np.ndarray, np.ndarray]:
        if self._posterior is None:
            mu, sigma = self._y_scale()
            phi_t = (self._phi_y - mu * self._phi_sum) / sigma
            beta = 1.0 / self.noise
            d = self._gram.shape[0]
            cov = np.linalg.inv(self.alpha * np.eye(d) + beta * self._gram)
            self._posterior = (beta * cov @ phi_t, cov)
        return self._posterior

    def predict(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        phi = _poly_features(X)
        mu, sigma = self._y_scale()
        if self.n_observed == 0:
            n = phi.shape[0]
            prior_var = self.noise + np.einsum(
                "ij,ij->i", phi, phi / self.alpha)
            return np.full(n, mu), sigma * np.sqrt(prior_var)
        mean_w, cov = self._solve()
        mean = phi @ mean_w
        var = self.noise + np.einsum("ij,jk,ik->i", phi, cov, phi)
        return mu + sigma * mean, sigma * np.sqrt(np.maximum(var, 0.0))


class KNNSurrogate(Surrogate):
    """Distance-weighted k-NN regression — the tiny-space fallback."""

    name = "knn"

    def __init__(self, dim: int, k: int = 3, eps: float = 1e-9):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.dim = dim
        self.k = k
        self.eps = eps
        self._X: list[np.ndarray] = []
        self._y: list[float] = []

    @property
    def n_observed(self) -> int:
        return len(self._y)

    def observe(self, x: np.ndarray, y: float) -> None:
        self._X.append(np.asarray(x, dtype=np.float64))
        self._y.append(float(y))

    def predict(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        n = X.shape[0]
        if not self._y:
            return np.zeros(n), np.ones(n)
        obs_x = np.stack(self._X)
        obs_y = np.asarray(self._y)
        spread = float(obs_y.std()) if len(self._y) >= 2 else 1.0
        spread = spread if spread > 0 else 1.0
        dist = np.sqrt(((X[:, None, :] - obs_x[None, :, :]) ** 2).sum(-1))
        k = min(self.k, len(self._y))
        idx = np.argsort(dist, axis=1)[:, :k]
        nd = np.take_along_axis(dist, idx, axis=1)
        ny = obs_y[idx]
        w = 1.0 / (nd + self.eps)
        w /= w.sum(axis=1, keepdims=True)
        mean = (w * ny).sum(axis=1)
        var = (w * (ny - mean[:, None]) ** 2).sum(axis=1)
        # distance-to-nearest term: far from every observation ⇒ uncertain,
        # scaled by the observed spread so units follow the objective
        d_near = nd[:, 0]
        std = np.sqrt(var + (spread * d_near) ** 2)
        return mean, np.maximum(std, 0.05 * spread)


#: below this cardinality the quadratic fit is typically underdetermined
#: relative to what the space can ever show it — k-NN explores better there
TINY_SPACE = 24


def make_surrogate(kind: str, dim: int, cardinality: int) -> Surrogate:
    """Build the surrogate ``kind`` ("ridge", "knn", or "auto") for a
    space with ``dim`` encoded features and ``cardinality`` configs."""
    if kind == "ridge":
        return BayesianRidgeSurrogate(dim)
    if kind == "knn":
        return KNNSurrogate(dim)
    if kind == "auto":
        if cardinality < max(TINY_SPACE, poly_dim(dim)):
            return KNNSurrogate(dim)
        return BayesianRidgeSurrogate(dim)
    raise ValueError(f"unknown surrogate kind {kind!r} "
                     "(ridge | knn | auto)")
