"""Config → feature-vector encoding for model-guided search.

Surrogate models need numeric inputs; :class:`~repro_torch.core.searchspace.Param`
domains are ordered but arbitrary (powers of two, the paper's 500-doubling
leading dimensions, or categorical flags). The encoding deliberately uses
the *level index* within each parameter's ordered domain, not the raw
value: the paper's spaces are geometric ladders (Sec. IV-A), so raw values
would compress the small end of every ladder into a corner of feature
space, while level indices spread the paper's 4×4×6 reduced DGEMM grid
uniformly. Parameters whose domain is non-numeric get a one-hot block
instead — there is no meaningful order-distance between ``"nmk"`` and
``"nkm"`` loop orders even though the domain tuple is ordered.

Features are scaled to [0, 1] per block, so distance-based surrogates
(:class:`~repro_torch.surrogate.model.KNNSurrogate`) weigh every parameter
equally regardless of domain size.

**Shape features** (the sweep layer, :mod:`repro_torch.sweep`): an encoder built
with a ``shape_space`` appends one block per shape parameter so a single
surrogate can learn the joint shape×config surface. Unlike config levels —
which are exact lookups raising ``KeyError`` off-domain — numeric shape
features are *continuous*: the value's position on the domain's log scale
(linear when the domain spans zero or negatives), clamped to [0, 1]. An
unseen shape between two tuned grid points lands between their features,
which is exactly what lets :class:`~repro_torch.sweep.oracle.ConfigOracle`
interpolate "best config for a shape nobody tuned".
"""

from __future__ import annotations

import math
import numbers
from typing import Optional, Sequence

import numpy as np

from ..core.searchspace import Config, Param, SearchSpace

__all__ = ["SpaceEncoder", "is_ordinal"]


def is_ordinal(param: Param) -> bool:
    """True iff every domain value is a real number (bools excluded):
    the level index is then a meaningful 1-D coordinate."""
    return all(isinstance(v, numbers.Real) and not isinstance(v, bool)
               for v in param.values)


def _numeric(v: object) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


class _ShapeAxis:
    """Continuous [0, 1] coordinate for one numeric shape parameter.

    Geometric ladders (the common case: matrix dims, working-set bytes)
    get a log scale so the feature is linear in the *level*, matching how
    config levels encode; domains touching zero or negatives fall back to
    linear. Values outside [lo, hi] clamp to the boundary — an
    extrapolated shape is "at the edge of what was tuned", not an error.
    """

    def __init__(self, values: Sequence):
        lo, hi = min(values), max(values)
        self.lo, self.hi = float(lo), float(hi)
        self.log = self.lo > 0.0 and self.hi > self.lo

    def coord(self, v: object) -> float:
        if not _numeric(v):
            raise KeyError(f"non-numeric shape value {v!r}")
        v = float(v)
        if self.hi == self.lo:
            return 0.0
        if self.log:
            if v <= 0.0:
                return 0.0
            t = ((math.log(v) - math.log(self.lo))
                 / (math.log(self.hi) - math.log(self.lo)))
        else:
            t = (v - self.lo) / (self.hi - self.lo)
        return min(max(t, 0.0), 1.0)


class SpaceEncoder:
    """Maps :class:`SearchSpace` configurations to fixed-width float64
    feature vectors.

    Ordinal parameters contribute one feature: their level index
    normalized to [0, 1] (a single-value domain encodes as 0). Categorical
    parameters contribute one 0/1 feature per level. The encoding is a
    pure function of the space's declared params, so two encoders over
    the same space agree feature-for-feature.

    With a ``shape_space``, every vector additionally carries that space's
    shape features (see module docstring) and :meth:`encode` requires the
    ``shape`` argument. ``config_dim`` is the width of the config block
    alone; ``dim`` includes the shape block.
    """

    def __init__(self, space: SearchSpace,
                 shape_space: Optional[SearchSpace] = None):
        self.space = space
        self.shape_space = shape_space
        self._ordinal: dict[str, dict[object, float]] = {}
        self._onehot: dict[str, dict[object, int]] = {}
        names: list[str] = []
        offset = 0
        self._offsets: dict[str, int] = {}
        for p in space.params:
            self._offsets[p.name] = offset
            if is_ordinal(p):
                denom = max(len(p.values) - 1, 1)
                self._ordinal[p.name] = {v: i / denom
                                         for i, v in enumerate(p.values)}
                names.append(p.name)
                offset += 1
            else:
                self._onehot[p.name] = {v: i for i, v in enumerate(p.values)}
                names.extend(f"{p.name}={v}" for v in p.values)
                offset += len(p.values)
        self.config_dim = offset
        # shape block: continuous axes for numeric shape params, one-hot
        # for categorical ones (a categorical "shape" cannot interpolate,
        # but it can still condition the model)
        self._shape_axes: dict[str, _ShapeAxis] = {}
        self._shape_onehot: dict[str, dict[object, int]] = {}
        self._shape_offsets: dict[str, int] = {}
        if shape_space is not None:
            for p in shape_space.params:
                self._shape_offsets[p.name] = offset
                if is_ordinal(p):
                    self._shape_axes[p.name] = _ShapeAxis(p.values)
                    names.append(f"shape:{p.name}")
                    offset += 1
                else:
                    self._shape_onehot[p.name] = {v: i for i, v
                                                  in enumerate(p.values)}
                    names.extend(f"shape:{p.name}={v}" for v in p.values)
                    offset += len(p.values)
        self.feature_names: tuple[str, ...] = tuple(names)
        self.dim = offset

    def encode(self, config: Config,
               shape: Optional[Config] = None) -> np.ndarray:
        """One configuration as a (dim,) float64 vector. Raises
        ``KeyError`` for config values outside the declared domains —
        encode in-space configs only (project foreign seeds first).
        Numeric shape values may fall anywhere (unseen shapes clamp to
        the tuned range); categorical shape values must be in-domain."""
        if self.shape_space is not None and shape is None:
            raise TypeError("encoder built with a shape_space requires "
                            "encode(config, shape=...)")
        x = np.zeros(self.dim, dtype=np.float64)
        for p in self.space.params:
            v = config[p.name]
            base = self._offsets[p.name]
            levels = self._ordinal.get(p.name)
            if levels is not None:
                x[base] = levels[v]
            else:
                x[base + self._onehot[p.name][v]] = 1.0
        if self.shape_space is not None:
            for p in self.shape_space.params:
                v = shape[p.name]
                base = self._shape_offsets[p.name]
                axis = self._shape_axes.get(p.name)
                if axis is not None:
                    x[base] = axis.coord(v)
                else:
                    x[base + self._shape_onehot[p.name][v]] = 1.0
        return x

    def shape_features(self, shape: Config) -> np.ndarray:
        """Just the shape block of :meth:`encode` — the coordinate the
        oracle's nearest-tuned-shape fallback measures distance in."""
        if self.shape_space is None:
            return np.zeros(0, dtype=np.float64)
        x = np.zeros(self.dim - self.config_dim, dtype=np.float64)
        for p in self.shape_space.params:
            v = shape[p.name]
            base = self._shape_offsets[p.name] - self.config_dim
            axis = self._shape_axes.get(p.name)
            if axis is not None:
                x[base] = axis.coord(v)
            else:
                x[base + self._shape_onehot[p.name][v]] = 1.0
        return x

    def decode(self, x: np.ndarray) -> Config:
        """Nearest in-domain configuration for a feature vector's config
        block: ordinal features snap to the closest level, one-hot blocks
        take their argmax. Exact inverse of :meth:`encode` for encoded
        in-space configs (shape features, if any, are ignored)."""
        x = np.asarray(x, dtype=np.float64)
        cfg: Config = {}
        for p in self.space.params:
            base = self._offsets[p.name]
            if p.name in self._ordinal:
                denom = max(len(p.values) - 1, 1)
                i = int(round(float(x[base]) * denom))
                cfg[p.name] = p.values[min(max(i, 0), len(p.values) - 1)]
            else:
                block = x[base:base + len(p.values)]
                cfg[p.name] = p.values[int(np.argmax(block))]
        return cfg

    def encode_all(self, configs: Sequence[Config],
                   shape: Optional[Config] = None) -> np.ndarray:
        """Stack of :meth:`encode` rows, shape (len(configs), dim)."""
        if not configs:
            return np.zeros((0, self.dim), dtype=np.float64)
        return np.stack([self.encode(c, shape=shape) for c in configs])
