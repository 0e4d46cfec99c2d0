"""Shape-sweep campaigns and the dispatch-time config oracle.

The paper tunes fixed benchmark shapes; production GEMMs arrive with
whatever (M, N, K) the workload dictates, and adjacent shapes can differ
enough that one tuned config does not fit all ("From Roofline to
Ruggedness"). This package turns the single-shape tuner into a
shape-generalizing service:

  * :mod:`~repro_torch.sweep.shapes` — canonical shape keys: each swept shape
    owns a ``"<base>@<shape_key>"`` namespace in the shared trial cache
    and run ledger;
  * :mod:`~repro_torch.sweep.strategy` — :class:`SweepStrategy`, the surrogate
    strategy over the *joint* shape×config feature space, warmed with
    per-fingerprint priors from sibling shapes' cached trials;
  * :mod:`~repro_torch.sweep.campaign` — :class:`SweepCampaign`, one
    :class:`~repro_torch.core.cache.TuningSession` per grid shape into one
    cache file and one ledger (strategy ``"sweep"``, stamped with the
    campaign name);
  * :mod:`~repro_torch.sweep.oracle` — :class:`ConfigOracle`, answering "best
    config for an *unseen* shape" by surrogate interpolation over the
    cache, falling back to the nearest tuned shape's incumbent
    (Spearman/distance-ranked, mirroring ``TrialCache.rank_donors``)
    while the model is cold.

CLI: ``python -m repro_torch.sweep``. Format and semantics: the JAX
package's ``docs/sweeps.md`` (the port keeps its cache keys, ledger
records and proposals).
"""

from .campaign import CampaignResult, ShapeOutcome, SweepCampaign
from .oracle import ConfigOracle, OracleAnswer
from .shapes import (SHAPE_SEP, parse_shape_key, shape_benchmark_name,
                     shape_key, split_benchmark_name)
from .strategy import SweepStrategy

__all__ = [
    "CampaignResult", "ConfigOracle", "OracleAnswer", "SHAPE_SEP",
    "ShapeOutcome", "SweepCampaign", "SweepStrategy", "parse_shape_key",
    "shape_benchmark_name", "shape_key", "split_benchmark_name",
]
