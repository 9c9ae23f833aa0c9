"""Greedy batch acquisition: local penalization and fantasizing (counterpart of
:mod:`trieste_tpu.acquisition.function.greedy_batch`).

* :class:`LocalPenalization` multiplies a positive base acquisition by soft or hard
  repulsion factors around the pending points, with the Lipschitz constant estimated from
  the posterior mean's gradients at random points (one ``torch.autograd.grad``).
* :class:`Fantasizer` conditions the model on hypothesized observations at the pending
  points (the posterior mean, "kriging believer", or a posterior sample) and builds the
  base acquisition on the conditioned posterior.

``generator=None`` makes one generator, seeded 0 on the data's device, at the first draw
(the Lipschitz points, the fantasized samples); later draws advance it.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import torch

from ...data import Dataset
from ...models.gp import posterior as P
from ...models.interfaces import FastUpdateModel, ProbabilisticModel
from ...space import SearchSpace
from ...utils.misc import new_generator
from ..interface import (
    AcquisitionFunction,
    SingleModelAcquisitionBuilder,
    SingleModelGreedyAcquisitionBuilder,
)
from ..utils import predictor
from .function import ExpectedImprovement, MakePositive, _min_posterior_mean, _std


def _soft_penalizer_fn(
    predict: Callable,
    lipschitz: torch.Tensor,
    eta: torch.Tensor,
    pending_points: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """The soft local penalizer of Gonzalez et al. (2016): for each pending point, the
    probability that ``x`` lies outside the ball the point excludes. ``x: [..., 1, D]
    -> [..., 1]``."""
    pending_mean, pending_var = predict(pending_points)  # [P, 1]
    radius = (pending_mean[:, 0] - eta) / lipschitz  # [P]
    scale = _std(pending_var[:, 0]) / lipschitz
    r = torch.linalg.norm(x - pending_points, dim=-1)  # [..., P]
    z = (r - radius) / (math.sqrt(2.0) * scale)
    return torch.prod(0.5 * torch.special.erfc(-z), dim=-1, keepdim=True)


def _hard_penalizer_fn(
    predict: Callable,
    lipschitz: torch.Tensor,
    eta: torch.Tensor,
    pending_points: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """The hard local penalizer of Alvi et al. (2019), ``x: [..., 1, D] -> [..., 1]``."""
    pending_mean, pending_var = predict(pending_points)
    gamma = pending_mean[:, 0] - eta + _std(pending_var[:, 0])  # [P]
    r = torch.linalg.norm(x - pending_points, dim=-1)  # [..., P]
    phi = torch.clamp_max(lipschitz * r / torch.clamp_min(gamma, 1e-12), 1.0)
    return torch.prod(phi, dim=-1, keepdim=True)


def _penalized_fn(base: Callable, penalizer: Callable, x: torch.Tensor) -> torch.Tensor:
    return base(x) * penalizer(x)


def _lipschitz_from_samples(model: ProbabilisticModel, samples: torch.Tensor) -> torch.Tensor:
    """The largest norm of the posterior mean's gradient over ``samples [N, D]``,
    floored at 10. The points are independent, so the gradient of the summed mean gives
    every point's own gradient."""
    with torch.enable_grad():
        x = samples.detach().requires_grad_(True)
        mean, _ = model.predict(x)
        (grads,) = torch.autograd.grad(mean[:, 0].sum(), x)
    return torch.clamp_min(torch.max(torch.linalg.norm(grads, dim=-1)), 10.0)


class LocalPenalization(SingleModelGreedyAcquisitionBuilder):
    """Greedy batches by penalization: the base acquisition (softplus of EI unless given)
    times a penalizer around each pending point. The base function, the Lipschitz
    constant and the incumbent are fixed once per BO step and kept through its batch."""

    def __init__(
        self,
        search_space: SearchSpace,
        num_samples: int = 500,
        penalizer: str = "soft",
        base_acquisition_function_builder: Optional[SingleModelAcquisitionBuilder] = None,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        if num_samples <= 0:
            raise ValueError(f"num_samples must be positive, got {num_samples}")
        if penalizer not in ("soft", "hard"):
            raise ValueError(f"penalizer must be 'soft' or 'hard', got {penalizer!r}")
        self._search_space = search_space
        self._num_samples = num_samples
        self._penalizer = _soft_penalizer_fn if penalizer == "soft" else _hard_penalizer_fn
        self._base_builder = base_acquisition_function_builder or MakePositive(
            ExpectedImprovement()
        )
        self._generator = generator
        self._base_fn: Optional[AcquisitionFunction] = None

    def prepare_acquisition_function(
        self,
        model: ProbabilisticModel,
        dataset: Optional[Dataset] = None,
        pending_points: Optional[torch.Tensor] = None,
    ) -> AcquisitionFunction:
        if dataset is None or len(dataset) == 0:
            raise ValueError("LocalPenalization requires a non-empty dataset")
        self._base_fn = self._base_builder.prepare_acquisition_function(model, dataset)
        if self._generator is None:
            self._generator = new_generator(dataset.device, 0)
        samples = self._search_space.sample(self._generator, self._num_samples)
        self._lipschitz = _lipschitz_from_samples(model, samples)
        self._eta = _min_posterior_mean(model, dataset)
        return self._with_penalization(model, pending_points)

    def update_acquisition_function(
        self,
        function: AcquisitionFunction,
        model: ProbabilisticModel,
        dataset: Optional[Dataset] = None,
        pending_points: Optional[torch.Tensor] = None,
        new_optimization_step: bool = True,
    ) -> AcquisitionFunction:
        if new_optimization_step or self._base_fn is None:
            return self.prepare_acquisition_function(model, dataset, pending_points)
        return self._with_penalization(model, pending_points)

    def _with_penalization(
        self, model: ProbabilisticModel, pending_points: Optional[torch.Tensor]
    ) -> AcquisitionFunction:
        if pending_points is None or pending_points.numel() == 0:
            return self._base_fn
        penalizer = partial(
            self._penalizer, predictor(model), self._lipschitz, self._eta, pending_points
        )
        return partial(_penalized_fn, self._base_fn, penalizer)

    def __repr__(self) -> str:
        return f"LocalPenalization({self._search_space!r}, {self._num_samples!r})"


def _broadcast_query(fn: Callable, query_points: torch.Tensor, fantasy_rank: int):
    """``fn`` at queries ``[Q..., N, D]`` against fantasy data with ``fantasy_rank``
    leading dims ``F...``: the query's leading dims go first, each query slice meeting
    every fantasy batch, so every output is ``[Q..., F..., N, ...]``."""
    if query_points.ndim == 2:
        return fn(query_points)
    lead = query_points.shape[:-2]
    return fn(query_points.reshape(lead + (1,) * fantasy_rank + query_points.shape[-2:]))


class _FantasizedModel:
    """A view of a fast-update model conditioned on fantasy data.

    The fantasy data may have leading batch dims (``fantasy_X [F..., M, D]``,
    ``fantasy_Y [F..., M, P]``), each an independently conditioned posterior, and the
    queries leading dims of their own (``[Q..., N, D]``): predictions are
    ``[Q..., F..., N, P]``. Leading fantasy dims need a model with ``params`` and
    ``posterior_cache`` (exact GPR), whose closed-form conditioning runs here; any other
    fast-update model gets its own conditional methods with flat fantasy data.
    """

    def __init__(
        self,
        model: FastUpdateModel,
        fantasy_data: Optional[Dataset] = None,
        *,
        fantasy_X: Optional[torch.Tensor] = None,
        fantasy_Y: Optional[torch.Tensor] = None,
    ):
        self._model = model
        if fantasy_data is not None:
            self._fantasy_data = fantasy_data
            self._fx, self._fy = fantasy_data.astuple()
        else:
            if fantasy_X is None or fantasy_Y is None:
                raise ValueError("provide fantasy_data or both fantasy_X and fantasy_Y")
            self._fx, self._fy = fantasy_X, fantasy_Y
            self._fantasy_data = (
                Dataset.from_arrays(fantasy_X, fantasy_Y, capacity=fantasy_X.shape[0])
                if fantasy_X.ndim == 2 else None
            )

    def _closed_form(self) -> bool:
        return hasattr(self._model, "params") and hasattr(self._model, "posterior_cache")

    def _flat_fantasy_dataset(self) -> Dataset:
        if self._fantasy_data is None:
            raise NotImplementedError(
                "fantasy data with leading batch dimensions requires a model with raw "
                "params/posterior_cache (exact GPR)"
            )
        return self._fantasy_data

    def _conditional(self, posterior_fn: Callable, method: str, query_points: torch.Tensor):
        if self._closed_form():
            m = self._model
            fn = partial(posterior_fn, m.params, m.posterior_cache, extra_X=self._fx,
                         extra_Y=self._fy)
            return _broadcast_query(fn, query_points, self._fx.ndim - 2)
        return getattr(self._model, method)(query_points, self._flat_fantasy_dataset())

    def predict(self, query_points: torch.Tensor):
        return self._conditional(P.conditional_predict_f, "conditional_predict_f", query_points)

    def predict_joint(self, query_points: torch.Tensor):
        return self._conditional(
            P.conditional_predict_joint, "conditional_predict_joint", query_points
        )

    def predict_y(self, query_points: torch.Tensor):
        return self._conditional(P.conditional_predict_y, "conditional_predict_y", query_points)

    def sample(
        self, generator: Optional[torch.Generator], query_points: torch.Tensor, num_samples: int
    ) -> torch.Tensor:
        """Conditioned joint samples ``[Q..., F..., S, N, P]``."""
        if self._closed_form():
            m = self._model
            fn = partial(P.conditional_predict_f_sample, generator, m.params, m.posterior_cache,
                         extra_X=self._fx, extra_Y=self._fy, num_samples=num_samples)
            return _broadcast_query(fn, query_points, self._fx.ndim - 2)
        return self._model.conditional_predict_f_sample(
            generator, query_points, self._flat_fantasy_dataset(), num_samples
        )

    def get_observation_noise(self) -> torch.Tensor:
        return self._model.get_observation_noise()

    def get_kernel(self):
        return self._model.get_kernel()

    def log(self, dataset: Optional[Dataset] = None) -> None:
        pass


class Fantasizer(SingleModelGreedyAcquisitionBuilder):
    """Greedy batches by fantasizing observations at the pending points and building
    the base acquisition (EI unless given) on the conditioned model.
    ``fantasize_method``: ``"KB"`` (kriging believer) takes the posterior mean as the
    observations, ``"sample"`` one joint posterior sample."""

    def __init__(
        self,
        base_acquisition_function_builder: Optional[SingleModelAcquisitionBuilder] = None,
        fantasize_method: str = "KB",
        *,
        generator: Optional[torch.Generator] = None,
    ):
        if fantasize_method not in ("KB", "sample"):
            raise ValueError(
                f"fantasize_method must be 'KB' or 'sample', got {fantasize_method!r}"
            )
        self._base_builder = base_acquisition_function_builder or ExpectedImprovement()
        self._fantasize_method = fantasize_method
        self._generator = generator

    def _fantasize(self, model: FastUpdateModel, pending_points: torch.Tensor) -> Dataset:
        if self._fantasize_method == "KB":
            fantasy_obs, _ = model.predict(pending_points)
        else:
            if self._generator is None:
                self._generator = new_generator(pending_points.device, 0)
            fantasy_obs = model.sample(self._generator, pending_points, 1)[0]
        return Dataset.from_arrays(pending_points, fantasy_obs, capacity=pending_points.shape[0])

    def prepare_acquisition_function(
        self,
        model: ProbabilisticModel,
        dataset: Optional[Dataset] = None,
        pending_points: Optional[torch.Tensor] = None,
    ) -> AcquisitionFunction:
        if not isinstance(model, FastUpdateModel):
            raise NotImplementedError(
                f"Fantasizer requires a FastUpdateModel, received {type(model)}"
            )
        if pending_points is None or pending_points.numel() == 0:
            return self._base_builder.prepare_acquisition_function(model, dataset)
        fantasy_data = self._fantasize(model, pending_points)
        # the incumbent is taken over the data and the fantasized observations
        full = dataset + fantasy_data if dataset is not None else fantasy_data
        return self._base_builder.prepare_acquisition_function(
            _FantasizedModel(model, fantasy_data), full
        )

    def __repr__(self) -> str:
        return f"Fantasizer({self._base_builder!r}, {self._fantasize_method!r})"
