"""Function forms of the acquisitions (counterpart of
:mod:`trieste_tpu.acquisition.function.functional`): each binds a model and its scalars
and returns the acquisition function itself, a :func:`functools.partial` of the same
module-level function that the builder's function binds. The Monte-Carlo forms take a
sample callable ``x -> samples`` whose base draws are fixed (a reparametrization
sampler's bound ``sample``). MUMBO waits for the multifidelity models.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence, Union

import torch

from ..interface import AcquisitionFunction
from ..utils import joint_predictor, predictor
from .active_learning import (
    IntegratedVarianceReduction,
    _bald_fn,
    _expected_feasibility_bichon_fn,
    _expected_feasibility_ranjan_fn,
    _predictive_variance_fn,
)
from .entropy import _gibbon_quality_fn, _gibbon_repulsion_fn, _mes_fn
from .function import (
    _aei_fn,
    _analytic_qei_fn,
    _batch_mc_ei_fn,
    _ei_fn,
    _mc_aei_fn,
    fast_constraints_feasibility,
    _mc_ei_fn,
    _monlcb_fn_spread,
    _poi_fn,
    _std,
)
from .greedy_batch import _hard_penalizer_fn, _penalized_fn, _soft_penalizer_fn
from .multi_objective import _BatchEHVIWithLazyMasks, _ehvi_fn, _hippo_penalty_fn, _member_states

PenalizedAcquisition = AcquisitionFunction
"""A base acquisition multiplied by a penalizer."""


def expected_improvement(model, eta: torch.Tensor) -> AcquisitionFunction:
    """Analytic EI against the incumbent ``eta``."""
    return partial(_ei_fn, predictor(model), eta)


def augmented_expected_improvement(model, eta: torch.Tensor) -> AcquisitionFunction:
    """Noise-augmented EI against ``eta``."""
    return partial(_aei_fn, predictor(model), eta, model.get_observation_noise())


def probability_below_threshold(model, threshold: torch.Tensor) -> AcquisitionFunction:
    """``P(f(x) < threshold)``: probability of improvement and of feasibility."""
    return partial(_poi_fn, predictor(model), threshold)


def _lcb_fn(predict: Callable, beta: float, x: torch.Tensor) -> torch.Tensor:
    mean, var = predict(x[..., 0, :])
    return (mean - beta * _std(var))[..., 0:1]


def lower_confidence_bound(model, beta: float) -> AcquisitionFunction:
    """``mean − beta·std``, to be minimized (its negative is
    :class:`~.function.NegativeLowerConfidenceBound`)."""
    return partial(_lcb_fn, predictor(model), beta)


def multiple_optimism_lower_confidence_bound(model, search_space_dim: int) -> AcquisitionFunction:
    """The vectorized fleet of negative LCBs over ``V`` slices, ``[..., V, D] -> [..., V]``."""
    return partial(_monlcb_fn_spread, predictor(model), search_space_dim)


def monte_carlo_expected_improvement(sample: Callable, eta: torch.Tensor) -> AcquisitionFunction:
    """Monte-Carlo EI from a sample callable with fixed base draws."""
    return partial(_mc_ei_fn, sample, eta)


def monte_carlo_augmented_expected_improvement(
    sample: Callable, model, eta: torch.Tensor
) -> AcquisitionFunction:
    """Monte-Carlo augmented EI."""
    return partial(_mc_aei_fn, sample, predictor(model), eta, model.get_observation_noise())


def batch_monte_carlo_expected_improvement(sample: Callable, eta: torch.Tensor) -> AcquisitionFunction:
    """Reparametrization-trick qEI."""
    return partial(_batch_mc_ei_fn, sample, eta)


def batch_expected_improvement(
    model, eta: torch.Tensor, qmc_points: torch.Tensor
) -> AcquisitionFunction:
    """Analytic qEI by Genz MVN CDFs over the QMC uniforms ``qmc_points``."""
    return partial(_analytic_qei_fn, joint_predictor(model), eta, qmc_points)


def predictive_variance(model, jitter: float = 0.0) -> AcquisitionFunction:
    """The determinant of the batch's predictive covariance, ``jitter`` on its diagonal."""
    return partial(_predictive_variance_fn, joint_predictor(model), jitter)


def bichon_ranjan_criterion(
    model, threshold: float, alpha: float, delta: int
) -> AcquisitionFunction:
    """Expected feasibility by the Bichon (``delta=1``) or Ranjan (``delta=2``) criterion."""
    fn = _expected_feasibility_bichon_fn if delta == 1 else _expected_feasibility_ranjan_fn
    return partial(fn, predictor(model), threshold, alpha)


def integrated_variance_reduction(
    model,
    integration_points: torch.Tensor,
    threshold: Optional[Union[float, Sequence[float]]] = None,
) -> AcquisitionFunction:
    """Integrated variance reduction over ``integration_points``; the builder weights
    them by ``threshold``."""
    return IntegratedVarianceReduction(integration_points, threshold).prepare_acquisition_function(
        model
    )


def bayesian_active_learning_by_disagreement(model, jitter: float = 1e-6) -> AcquisitionFunction:
    """BALD; ``jitter`` floors the latent variance."""
    return partial(_bald_fn, predictor(model), jitter)


def min_value_entropy_search(model, min_value_samples: torch.Tensor) -> AcquisitionFunction:
    """MES against sampled minimum values ``[S, 1]``."""
    return partial(_mes_fn, predictor(model), min_value_samples)


def gibbon_quality_term(model, min_value_samples: torch.Tensor) -> AcquisitionFunction:
    """GIBBON's quality term against sampled minimum values ``[S, 1]``."""
    return partial(
        _gibbon_quality_fn, predictor(model), model.get_observation_noise(), min_value_samples
    )


def gibbon_repulsion_term(model, pending_points: torch.Tensor) -> AcquisitionFunction:
    """GIBBON's repulsion from ``pending_points [P, D]``."""
    return partial(
        _gibbon_repulsion_fn, joint_predictor(model), model.get_observation_noise(),
        pending_points,
    )


def soft_local_penalizer(
    model, pending_points: torch.Tensor, lipschitz_constant: torch.Tensor, eta: torch.Tensor
) -> AcquisitionFunction:
    """The soft penalizer of Gonzalez et al. around ``pending_points``."""
    return partial(_soft_penalizer_fn, predictor(model), lipschitz_constant, eta, pending_points)


def hard_local_penalizer(
    model, pending_points: torch.Tensor, lipschitz_constant: torch.Tensor, eta: torch.Tensor
) -> AcquisitionFunction:
    """The hard penalizer of Alvi et al. around ``pending_points``."""
    return partial(_hard_penalizer_fn, predictor(model), lipschitz_constant, eta, pending_points)


def local_penalizer(base: AcquisitionFunction, penalizer: AcquisitionFunction) -> AcquisitionFunction:
    """``base`` times ``penalizer``."""
    return partial(_penalized_fn, base, penalizer)


def expected_hv_improvement(model, partition_bounds) -> AcquisitionFunction:
    """Analytic EHVI over the cells ``(lower [K, M], upper [K, M])``."""
    lower, upper = partition_bounds
    return partial(_ehvi_fn, predictor(model), lower, upper)


def batch_ehvi(sample: Callable, sampler_jitter: float, partition_bounds) -> AcquisitionFunction:
    """qEHVI from a sample callable with fixed base draws over the cells
    ``(lower, upper)``; ``sampler_jitter`` is the sampler's own and not read here."""
    lower, upper = partition_bounds
    return _BatchEHVIWithLazyMasks(sample, lower, upper)


def hippo_penalizer(models, pending_points: torch.Tensor) -> AcquisitionFunction:
    """HIPPO's correlation penalty against ``pending_points`` for an exact GP or a stack
    of them."""
    return partial(_hippo_penalty_fn, _member_states(models), pending_points)
