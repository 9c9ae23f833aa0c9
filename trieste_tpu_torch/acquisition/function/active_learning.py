"""Active-learning acquisition functions (counterpart of
:mod:`trieste_tpu.acquisition.function.active_learning`): predictive variance, expected
feasibility (the Bichon and Ranjan criteria) for level-set estimation, integrated
variance reduction, and BALD for Bernoulli classifiers."""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional, Sequence, Union

import torch

from ...data import Dataset
from ...models.gp import posterior as P
from ...models.interfaces import ProbabilisticModel
from ...ops.linalg import nan_cholesky, solve_lower
from ...utils.misc import jitter_for
from ..interface import AcquisitionFunction, SingleModelAcquisitionBuilder
from ..utils import joint_predictor, predictor
from .function import _normal_pdf, _std

_ndtr = torch.special.ndtr


def _predictive_variance_fn(predict_joint: Callable, jitter: float, x: torch.Tensor) -> torch.Tensor:
    """The determinant of the batch's predictive covariance, its diagonal jittered,
    summed over outputs: ``[..., B, D] -> [..., 1]``."""
    _, cov = predict_joint(x)  # [..., L, B, B]
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    sign, logdet = torch.linalg.slogdet(cov + jitter * eye)
    return torch.sum(sign * torch.exp(logdet), dim=-1, keepdim=True)


class PredictiveVariance(SingleModelAcquisitionBuilder):
    """Maximizes the determinant of the batch's predictive covariance."""

    def __init__(self, jitter: float = 1e-6):
        self._jitter = jitter

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        return partial(_predictive_variance_fn, joint_predictor(model), self._jitter)

    def __repr__(self) -> str:
        return f"PredictiveVariance(jitter={self._jitter!r})"


def _expected_feasibility_bichon_fn(
    predict: Callable, threshold: float, alpha: float, x: torch.Tensor
) -> torch.Tensor:
    """Bichon's expected feasibility (delta = 1), ``[..., 1, D] -> [..., 1]``."""
    mean, var = predict(x[..., 0, :])
    std = _std(var)
    t = (threshold - mean) / std
    t_plus, t_minus = t + alpha, t - alpha
    G = (
        alpha * (_ndtr(t_plus) - _ndtr(t_minus))
        - t * (2.0 * _ndtr(t) - _ndtr(t_plus) - _ndtr(t_minus))
        - (2.0 * _normal_pdf(t) - _normal_pdf(t_plus) - _normal_pdf(t_minus))
    )
    return (std * G)[..., 0:1]


def _expected_feasibility_ranjan_fn(
    predict: Callable, threshold: float, alpha: float, x: torch.Tensor
) -> torch.Tensor:
    """Ranjan's expected feasibility (delta = 2), ``[..., 1, D] -> [..., 1]``."""
    mean, var = predict(x[..., 0, :])
    t = (threshold - mean) / _std(var)
    t_plus, t_minus = t + alpha, t - alpha
    G = (
        (alpha**2 - 1.0 - t**2) * (_ndtr(t_plus) - _ndtr(t_minus))
        - 2.0 * t * (_normal_pdf(t_plus) - _normal_pdf(t_minus))
        + t_plus * _normal_pdf(t_plus)
        - t_minus * _normal_pdf(t_minus)
    )
    return (var * G)[..., 0:1]


class ExpectedFeasibility(SingleModelAcquisitionBuilder):
    """Level-set active learning: where is ``f`` within ``alpha`` standard deviations of
    ``threshold``, by the Bichon (``delta=1``) or Ranjan (``delta=2``) criterion."""

    def __init__(self, threshold: float, alpha: float = 1.0, delta: int = 1):
        if alpha <= 0:
            raise ValueError(f"alpha must be positive, got {alpha}")
        if delta not in (1, 2):
            raise ValueError(f"delta must be 1 or 2, got {delta}")
        self._threshold = threshold
        self._alpha = alpha
        self._delta = delta

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        fn = _expected_feasibility_bichon_fn if self._delta == 1 else _expected_feasibility_ranjan_fn
        return partial(fn, predictor(model), self._threshold, self._alpha)

    def __repr__(self) -> str:
        return f"ExpectedFeasibility({self._threshold!r}, {self._alpha!r}, {self._delta!r})"


def _integrated_variance_reduction_fn(
    params: P.GPRParams,
    cache: P.GPRCache,
    integration_points: torch.Tensor,
    threshold_weights: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """The weighted sum, over the integration points ``t``, of the posterior variance
    that observing the batch ``x [..., B, D]`` would remove: by the exact-GP identity,
    ``k(t, B) (K_BB + σ²I)⁻¹ k(B, t)`` with posterior covariances. Every batch of the
    leading dims at once: ``[..., B, D] -> [..., 1]``."""
    flat = x.reshape((-1,) + x.shape[-2:])  # [R, B, D]
    _, cov_bb = P.predict_joint(params, cache, flat)  # [R, L, B, B]
    cov_bb = cov_bb[:, 0]
    eye = torch.eye(cov_bb.shape[-1], dtype=cov_bb.dtype, device=cov_bb.device)
    Lb = nan_cholesky(cov_bb + (params.noise_variance + jitter_for(cov_bb.dtype)) * eye)
    cov_bt = P.covariance_between_points(params, cache, flat, integration_points)  # [R, B, T]
    reduction = torch.sum(torch.square(solve_lower(Lb, cov_bt)), dim=-2)  # [R, T]
    return torch.sum(reduction * threshold_weights, dim=-1).reshape(x.shape[:-2] + (1,))


class IntegratedVarianceReduction(SingleModelAcquisitionBuilder):
    """Integrated variance reduction over fixed ``integration_points [T, D]``, weighted,
    where ``threshold`` is given, by the posterior density at the threshold (one value)
    or the posterior probability of the interval (two values). Needs an exact GP."""

    def __init__(
        self,
        integration_points: torch.Tensor,
        threshold: Optional[Union[float, Sequence[float]]] = None,
    ):
        self._integration_points = integration_points
        self._threshold = threshold

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        if not hasattr(model, "params") or not hasattr(model, "posterior_cache"):
            raise NotImplementedError(
                "IntegratedVarianceReduction currently requires an exact-GP model"
            )
        points = self._integration_points
        if self._threshold is None:
            weights = torch.ones(points.shape[0], dtype=points.dtype, device=points.device)
        else:
            t = torch.atleast_1d(torch.as_tensor(self._threshold, dtype=points.dtype))
            mean, var = model.predict(points)
            std = _std(var)
            if t.shape[0] == 1:
                weights = _normal_pdf((float(t[0]) - mean[:, 0]) / std[:, 0])
            else:
                weights = (_ndtr((float(t[1]) - mean[:, 0]) / std[:, 0])
                           - _ndtr((float(t[0]) - mean[:, 0]) / std[:, 0]))
        return partial(
            _integrated_variance_reduction_fn, model.params, model.posterior_cache, points,
            weights,
        )

    def __repr__(self) -> str:
        return f"IntegratedVarianceReduction(threshold={self._threshold!r})"


_BALD_C = math.sqrt(math.pi * math.log(2.0) / 2.0)


def _binary_entropy(p: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(p, 1e-9, 1.0 - 1e-9)
    return -p * torch.log(p) - (1.0 - p) * torch.log(1.0 - p)


def _bald_fn(predict: Callable, jitter: float, x: torch.Tensor) -> torch.Tensor:
    """BALD for a probit-Bernoulli classifier over the latent GP, by the approximation
    of Houlsby et al. (2011); ``jitter`` floors the latent variance."""
    mean, var = predict(x[..., 0, :])
    mean, var = mean[..., 0], torch.clamp_min(var[..., 0], jitter)
    marginal_entropy = _binary_entropy(_ndtr(mean / torch.sqrt(1.0 + var)))
    conditional_entropy = (
        _BALD_C / torch.sqrt(var + _BALD_C**2)
        * torch.exp(-(mean**2) / (2.0 * (var + _BALD_C**2)))
        * math.log(2.0)
    )
    return (marginal_entropy - conditional_entropy)[..., None]


class BayesianActiveLearningByDisagreement(SingleModelAcquisitionBuilder):
    """BALD: the information an observation gives about the latent function."""

    def __init__(self, jitter: float = 1e-6):
        self._jitter = jitter

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        return partial(_bald_fn, predictor(model), self._jitter)

    def __repr__(self) -> str:
        return f"BayesianActiveLearningByDisagreement({self._jitter!r})"
