"""Exact Gaussian-process-regression model (counterpart of
:mod:`trieste_tpu.models.gp.gpr`): a thin mutable shell over immutable state
(``GPRParams``, the padded dataset and the ``GPRCache``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...data import Dataset
from . import posterior as P
from .priors import GPPriors
from .training import GPRTrainingResult, fit_gpr


def _linvt_ok(params: P.GPRParams) -> bool:
    """Tiny-noise gate for the fused-path triangular inverse, decided when the cache is
    built: with a noise/signal ratio below 1e-5 the true posterior variance near the data
    is below the fused kernel's absolute variance contract, so ``LinvT`` is not built
    (saving its O(C³) cost too) and prediction takes the exact path."""
    noise = float(params.noise_variance)
    variance = float(params.kernel.variance)
    return noise / max(variance, 1e-30) >= 1e-5


class GaussianProcessRegression:
    """Exact GPR with a Gaussian likelihood and a constant mean function."""

    def __init__(
        self,
        params: P.GPRParams,
        dataset: Dataset,
        *,
        num_kernel_samples: int = 10,
        train_noise: bool = True,
        max_optimize_iters: int = 100,
        optimize_generator: Optional[torch.Generator] = None,
        priors: Optional[GPPriors] = None,
    ):
        self._params = params
        self._dataset = dataset
        self._num_kernel_samples = num_kernel_samples
        self._train_noise = train_noise
        self._max_optimize_iters = max_optimize_iters
        self._priors = priors
        if optimize_generator is None:
            optimize_generator = torch.Generator(device=dataset.device).manual_seed(0)
        self._generator = optimize_generator
        self._cache = self._build_cache()

    def _build_cache(self) -> P.GPRCache:
        ds = self._dataset
        return P.build_cache(
            self._params, ds.query_points, ds.observations, ds.mask,
            with_linvt=_linvt_ok(self._params),
        )

    @property
    def params(self) -> P.GPRParams:
        return self._params

    @params.setter
    def params(self, params: P.GPRParams) -> None:
        """Replace the hyperparameters and refresh the posterior cache."""
        self._params = params
        self._cache = self._build_cache()

    @property
    def posterior_cache(self) -> P.GPRCache:
        return self._cache

    @property
    def dataset(self) -> Dataset:
        return self._dataset

    def predict(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return P.predict_f(self._params, self._cache, query_points)

    def update(self, dataset: Dataset) -> None:
        """Set the data and refresh the posterior cache."""
        if dataset.dimension != self._dataset.dimension:
            raise ValueError(
                f"dataset dimension {dataset.dimension} != model dimension "
                f"{self._dataset.dimension}"
            )
        if dataset.num_outputs != self._dataset.num_outputs:
            raise ValueError(
                f"dataset has {dataset.num_outputs} outputs, model has "
                f"{self._dataset.num_outputs}"
            )
        self._dataset = dataset
        self._cache = self._build_cache()

    def optimize(self, dataset: Dataset) -> GPRTrainingResult:
        """Multi-start training of the hyperparameters on ``dataset``."""
        result = fit_gpr(
            self._generator, self._params, dataset.query_points, dataset.observations,
            dataset.mask, num_starts=self._num_kernel_samples, train_noise=self._train_noise,
            max_iters=self._max_optimize_iters, priors=self._priors,
        )
        self._params = result.params
        self._dataset = dataset
        self._cache = self._build_cache()
        return result

    def __repr__(self) -> str:
        return (
            f"GaussianProcessRegression(kernel={self._params.kernel.kind}, "
            f"n={len(self._dataset)})"
        )
