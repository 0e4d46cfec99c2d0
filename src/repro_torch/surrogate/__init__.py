"""Model-guided search: surrogate + acquisition strategies on the
ask/tell layer.

The paper's techniques cut the *cost per configuration* (CI-convergence,
incumbent pruning) and the *space itself* (constraint reduction); this
package cuts the *number of configurations worth visiting* by learning
the landscape as the search runs. It plugs into the existing
:class:`~repro_torch.core.strategy.SearchStrategy` protocol — the
:class:`~repro_torch.core.tuner.Tuner` engine, execution backends, trial cache,
run ledger, and transfer-seed plumbing all work unchanged.

Layers (see the JAX package's ``docs/strategies.md`` § Model-guided
search):

  * :mod:`~repro_torch.surrogate.encoding` — configs → numeric feature vectors
    (ordinal level indices, one-hot categoricals);
  * :mod:`~repro_torch.surrogate.model` — pure-numpy surrogates with predictive
    uncertainty (incremental Bayesian ridge on polynomial features, k-NN
    fallback for tiny spaces);
  * :mod:`~repro_torch.surrogate.acquisition` — Expected Improvement and UCB,
    built on the CI machinery in :mod:`repro_torch.core.confidence` so
    acquisition respects the paper's noise model;
  * :mod:`~repro_torch.surrogate.strategy` — :class:`SurrogateStrategy`
    (batched top-k acquisition) and :class:`BanditStrategy`
    (parameter-level Thompson sampling for very large spaces).

The port keeps this layer on numpy, not torch: it is host-side statistics
over a few dozen trials, the explicit ``np.random.default_rng(seed)``
generators make the same seed propose the same configurations as the JAX
package, and the ridge posterior keeps ``np.linalg.inv`` (a torch solve
would differ in the last bits and could flip an acquisition argmax).
Nothing here touches a device.
"""

from .acquisition import (expected_improvement, noise_adjusted_best,
                          upper_confidence_bound)
from .encoding import SpaceEncoder, is_ordinal
from .model import (BayesianRidgeSurrogate, KNNSurrogate, Surrogate,
                    make_surrogate, poly_dim)
from .strategy import BanditStrategy, SurrogateStrategy

__all__ = [
    "BanditStrategy", "BayesianRidgeSurrogate", "KNNSurrogate",
    "SpaceEncoder", "Surrogate", "SurrogateStrategy",
    "expected_improvement", "is_ordinal", "make_surrogate",
    "noise_adjusted_best", "poly_dim", "upper_confidence_bound",
]
