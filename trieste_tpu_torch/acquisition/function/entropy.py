"""Entropy-based acquisition functions (counterpart of
:mod:`trieste_tpu.acquisition.function.entropy`): min-value entropy search (MES), GIBBON,
and the multifidelity MUMBO with the per-fidelity cost weighting.

Each samples the value of the global minimum over a random grid (MES and GIBBON add the
observed points; MUMBO samples the top fidelity) by a Thompson sampler of minimum values
(Gumbel by default). ``generator=None`` makes one
generator, seeded 0 on the data's device, at the first preparation; every later
preparation advances it, so each BO step draws a new grid and new samples.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence

import torch

from ...data import Dataset
from ...models.interfaces import (
    ProbabilisticModel,
    SupportsCovarianceWithTopFidelity,
    SupportsGetObservationNoise,
)
from ...space import SearchSpace
from ...utils.misc import new_generator
from ..interface import (
    AcquisitionFunction,
    SingleModelAcquisitionBuilder,
    SingleModelGreedyAcquisitionBuilder,
)
from ..sampler import GumbelSampler, ThompsonSampler
from ..utils import joint_predictor, predictor
from .function import _normal_pdf

CLAMP_LB = 1e-8


def _truncation_terms(
    predict: Callable, min_value_samples: torch.Tensor, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(var, gamma, 1 − Φ(gamma))`` at ``x [..., 1, D]`` against the sampled minima
    ``[S, 1]``, the last two ``[..., S]``; the variance and the tail floored at
    ``CLAMP_LB``."""
    mean, var = predict(x[..., 0, :])  # [..., 1]
    var = torch.clamp_min(var, CLAMP_LB)
    gamma = (min_value_samples[:, 0] - mean) / torch.sqrt(var)  # [..., S]
    minus_cdf = torch.clamp(1.0 - torch.special.ndtr(gamma), CLAMP_LB, 1.0)
    return var, gamma, minus_cdf


def _mes_fn(predict: Callable, min_value_samples: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """MES: the expected reduction of the entropy of the minimum's value, averaged over
    the sampled minima. ``x: [..., 1, D] -> [..., 1]``."""
    _, gamma, minus_cdf = _truncation_terms(predict, min_value_samples, x)
    value = -gamma * _normal_pdf(gamma) / (2.0 * minus_cdf) - torch.log(minus_cdf)
    return torch.mean(value, dim=-1, keepdim=True)


class MinValueEntropySearch(SingleModelAcquisitionBuilder):
    """MES: scores candidates by how much observing them would tell about the value of
    the global minimum, sampled on a grid of ``grid_size`` random points plus the data."""

    def __init__(
        self,
        search_space: SearchSpace,
        num_samples: int = 5,
        grid_size: int = 1000,
        min_value_sampler: Optional[ThompsonSampler] = None,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        if num_samples <= 0:
            raise ValueError(f"num_samples must be positive, got {num_samples}")
        if grid_size <= 0:
            raise ValueError(f"grid_size must be positive, got {grid_size}")
        if min_value_sampler is not None and not min_value_sampler.sample_min_value:
            raise ValueError("MinValueEntropySearch requires a sample_min_value sampler")
        self._search_space = search_space
        self._num_samples = num_samples
        self._grid_size = grid_size
        self._sampler = min_value_sampler or GumbelSampler()
        self._generator = generator

    def _sample_min_values(self, model: ProbabilisticModel, dataset: Dataset) -> torch.Tensor:
        """Draw the grid, then the minimum values on it: ``[S, 1]``."""
        if self._generator is None:
            self._generator = new_generator(dataset.device, 0)
        grid = self._search_space.sample(self._generator, self._grid_size)
        return self._min_values_on_grid(model, dataset, grid)

    def _min_values_on_grid(
        self, model: ProbabilisticModel, dataset: Dataset, grid: torch.Tensor
    ) -> torch.Tensor:
        """The minimum values sampled on ``grid`` plus the observed points."""
        at = torch.cat([grid, dataset.trimmed_query_points])
        return self._sampler.sample(model, self._num_samples, at, generator=self._generator)

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        if dataset is None or len(dataset) == 0:
            raise ValueError("MinValueEntropySearch requires a non-empty dataset")
        return partial(_mes_fn, predictor(model), self._sample_min_values(model, dataset))

    def __repr__(self) -> str:
        return f"MinValueEntropySearch({self._search_space!r}, {self._num_samples!r})"


def _gibbon_quality_fn(
    predict: Callable,
    noise_variance: torch.Tensor,
    min_value_samples: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """GIBBON's quality term: a lower bound on the information that observing ``y(x)``
    gives about the minimum's value. ``x: [..., 1, D] -> [..., 1]``."""
    var, gamma, minus_cdf = _truncation_terms(predict, min_value_samples, x)
    return _information_lower_bound(var / (var + noise_variance), gamma, minus_cdf)


def _information_lower_bound(
    rho2: torch.Tensor, gamma: torch.Tensor, minus_cdf: torch.Tensor
) -> torch.Tensor:
    """``-E_S[log(1 − rho² (1 − r(r − gamma)))] / 2`` with ``r = φ(gamma)/Ψ``, the variance
    ratio of the truncated latent inside: GIBBON's and MUMBO's bound, given the squared
    correlation ``rho2 [..., 1]`` of the observation with the latent and ``[..., S]``."""
    ratio = _normal_pdf(gamma) / minus_cdf
    trunc_ratio = torch.clamp(1.0 - ratio * (ratio - gamma), CLAMP_LB, 1.0)
    inner = torch.clamp(1.0 - rho2 * (1.0 - trunc_ratio), CLAMP_LB, 1.0)
    return -0.5 * torch.mean(torch.log(inner), dim=-1, keepdim=True)


def _gibbon_repulsion_fn(
    predict_joint: Callable,
    noise_variance: torch.Tensor,
    pending_points: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """GIBBON's repulsion term: half the log-determinant of the correlation matrix of
    the observations at ``[pending; x]``, for every candidate at once (one joint
    prediction over ``[N, P+1, D]``). ``x: [..., 1, D] -> [..., 1]``."""
    flat = x.reshape(-1, x.shape[-1])  # [N, D]
    pending = pending_points.expand((flat.shape[0],) + pending_points.shape)
    _, cov = predict_joint(torch.cat([pending, flat[:, None, :]], dim=1))  # [N, L, P+1, P+1]
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    cov = cov[:, 0] + noise_variance * eye
    d = torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1))
    _, logdet = torch.linalg.slogdet(cov / (d[:, :, None] * d[:, None, :]))
    return (0.5 * logdet).reshape(x.shape[:-2] + (1,))


def _gibbon_with_repulsion_fn(
    quality: Callable, repulsion: Callable, x: torch.Tensor
) -> torch.Tensor:
    return quality(x) + repulsion(x)


class GIBBON(SingleModelGreedyAcquisitionBuilder):
    """General-purpose Information-Based Bayesian OptimisatioN: a cheap approximation of
    MES whose greedy batches add a determinant-based repulsion from the pending points.
    The minimum values are sampled once per BO step and kept through its batch.
    ``rescaled_repulsion`` is accepted as the JAX package accepts it, and read by neither:
    the repulsion is never rescaled."""

    def __init__(
        self,
        search_space: SearchSpace,
        num_samples: int = 5,
        grid_size: int = 1000,
        min_value_sampler: Optional[ThompsonSampler] = None,
        rescaled_repulsion: bool = True,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        self._mes = MinValueEntropySearch(
            search_space, num_samples, grid_size, min_value_sampler, generator=generator
        )
        self._min_value_samples: Optional[torch.Tensor] = None

    def prepare_acquisition_function(
        self,
        model: ProbabilisticModel,
        dataset: Optional[Dataset] = None,
        pending_points: Optional[torch.Tensor] = None,
    ) -> AcquisitionFunction:
        if dataset is None or len(dataset) == 0:
            raise ValueError("GIBBON requires a non-empty dataset")
        if not isinstance(model, SupportsGetObservationNoise):
            raise ValueError("GIBBON requires a model with observation noise")
        self._min_value_samples = self._mes._sample_min_values(model, dataset)
        return self._function(model, pending_points)

    def update_acquisition_function(
        self,
        function: AcquisitionFunction,
        model: ProbabilisticModel,
        dataset: Optional[Dataset] = None,
        pending_points: Optional[torch.Tensor] = None,
        new_optimization_step: bool = True,
    ) -> AcquisitionFunction:
        if new_optimization_step or self._min_value_samples is None:
            return self.prepare_acquisition_function(model, dataset, pending_points)
        return self._function(model, pending_points)

    def _function(
        self, model: ProbabilisticModel, pending_points: Optional[torch.Tensor]
    ) -> AcquisitionFunction:
        noise = model.get_observation_noise()
        quality = partial(_gibbon_quality_fn, predictor(model), noise, self._min_value_samples)
        if pending_points is None or pending_points.numel() == 0:
            return quality
        repulsion = partial(_gibbon_repulsion_fn, joint_predictor(model), noise, pending_points)
        return partial(_gibbon_with_repulsion_fn, quality, repulsion)

    def __repr__(self) -> str:
        return f"GIBBON({self._mes._search_space!r})"


# -- multifidelity entropy search --------------------------------------------------------


def _mumbo_fn(
    predict: Callable,
    cov_with_top: Callable,
    predict_top: Callable,
    noise_variance: torch.Tensor,
    min_value_samples: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """MUMBO in its information-lower-bound form: an observation at fidelity ``m`` informs
    the top fidelity's minimum through ``rho(x) = cov(y_m, f_top) / sqrt(var(y_m)
    var(f_top))``. ``x: [..., 1, D+1]`` (a trailing fidelity column) ``-> [..., 1]``."""
    xq = x[..., 0, :]
    _, var_m = predict(xq)
    var_y = torch.clamp_min(var_m, CLAMP_LB) + noise_variance
    cov_mt = cov_with_top(xq)  # [..., 1]
    var_t, gamma, minus_cdf = _truncation_terms(predict_top, min_value_samples, x)
    rho2 = torch.clamp(torch.square(cov_mt) / (var_y * var_t), 0.0, 1.0 - CLAMP_LB)
    return _information_lower_bound(rho2, gamma, minus_cdf)


def _unchecked(model, name: str) -> Callable:
    """A multifidelity model's ``name`` without the fidelity check where it has one: the
    optimizer's points take their fidelity from the space, and a check would read the
    device at every evaluation."""
    return getattr(model, f"{name}_unchecked", None) or getattr(model, name)


class _TopFidelityView:
    """A multifidelity model seen as a plain model at its top fidelity."""

    def __init__(self, model, top: int):
        self._model = model
        self._top = float(top)

    def _at_top(self, x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        x[..., -1] = self._top
        return x

    def predict(self, x: torch.Tensor):
        return _unchecked(self._model, "predict")(self._at_top(x))

    def sample(self, generator, x: torch.Tensor, num_samples: int) -> torch.Tensor:
        return self._model.sample(generator, self._at_top(x), num_samples)


def _mumbo_partial(model, noise: torch.Tensor, min_value_samples: torch.Tensor):
    top_view = _TopFidelityView(model, model.num_fidelities - 1)
    return partial(
        _mumbo_fn,
        _unchecked(model, "predict"),
        _unchecked(model, "covariance_with_top_fidelity"),
        top_view.predict,
        noise,
        min_value_samples,
    )


class MUMBO(SingleModelAcquisitionBuilder):
    """MUlti-task Max-value Bayesian Optimization: multifidelity MES. It needs a model
    with ``covariance_with_top_fidelity`` and a space whose trailing coordinate is the
    fidelity. The minimum values are sampled on ``grid_size`` random points of the space
    moved to the top fidelity. A model without ``get_observation_noise`` (AR(1) has none)
    is taken as noise-free."""

    def __init__(
        self,
        search_space: SearchSpace,
        num_samples: int = 5,
        grid_size: int = 1000,
        min_value_sampler: Optional[ThompsonSampler] = None,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        self._mes = MinValueEntropySearch(
            search_space, num_samples, grid_size, min_value_sampler, generator=generator
        )

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        if not isinstance(model, SupportsCovarianceWithTopFidelity):
            raise ValueError("MUMBO requires a multifidelity model")
        if dataset is None or len(dataset) == 0:
            raise ValueError("MUMBO requires a non-empty dataset")
        mes = self._mes
        if mes._generator is None:
            mes._generator = new_generator(dataset.device, 0)
        top_view = _TopFidelityView(model, model.num_fidelities - 1)
        grid = top_view._at_top(mes._search_space.sample(mes._generator, mes._grid_size))
        samples = mes._sampler.sample(top_view, mes._num_samples, grid, generator=mes._generator)
        noise = (
            model.get_observation_noise() if hasattr(model, "get_observation_noise")
            else torch.zeros((), dtype=samples.dtype, device=samples.device)
        )
        return _mumbo_partial(model, noise, samples)

    def __repr__(self) -> str:
        return "MUMBO()"


def _fidelity_costs(costs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The cost of each candidate's fidelity, ``x: [..., 1, D+1] -> [..., 1]``."""
    fid = x[..., 0, -1].long()
    return costs.to(device=x.device, dtype=x.dtype)[fid][..., None]


def _cost_weighted_fn(base: Callable, costs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return base(x) / _fidelity_costs(costs, x)


def _reciprocal_cost_fn(costs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return 1.0 / _fidelity_costs(costs, x)


class CostWeighting(SingleModelAcquisitionBuilder):
    """The reciprocal of each fidelity's observation cost, ``1 / cost(fidelity)``, to be
    combined by product, as in ``Product(MUMBO(space).using(OBJECTIVE),
    CostWeighting(costs).using(OBJECTIVE))``. ``apply_to(base_fn)`` gives
    ``base_fn(x) / cost(fidelity)`` directly. The costs take the device and dtype of the
    data at preparation, of the points at each call of ``apply_to``'s function."""

    def __init__(self, observation_costs: Sequence[float]):
        self._costs = torch.as_tensor(observation_costs, dtype=torch.float64)

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        costs = self._costs
        if dataset is not None:
            costs = costs.to(device=dataset.device, dtype=dataset.query_points.dtype)
        return partial(_reciprocal_cost_fn, costs)

    def update_acquisition_function(
        self,
        function: AcquisitionFunction,
        model: ProbabilisticModel,
        dataset: Optional[Dataset] = None,
    ) -> AcquisitionFunction:
        return function

    def apply_to(self, base_fn: AcquisitionFunction) -> AcquisitionFunction:
        return partial(_cost_weighted_fn, base_fn, self._costs)

    def __repr__(self) -> str:
        return f"CostWeighting({self._costs.tolist()!r})"
