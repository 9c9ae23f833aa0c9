"""Exact Gaussian-process-regression model (counterpart of
:mod:`trieste_tpu.models.gp.gpr`): a thin mutable shell over immutable state
(``GPRParams``, the padded dataset and the ``GPRCache``)."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ...data import Dataset
from ...ops.kernels import Stationary
from ...parallel import current_pool_sharding, round_to_mesh
from ...profiling import host_read, span
from ..interfaces import ReparametrizationSampler, TrajectorySampler
from . import posterior as P
from .priors import GPPriors
from .training import GPRTrainingResult, fit_gpr

cache_builds = 0
"""Posterior cache builds (``GaussianProcessRegression._build_cache`` calls)."""


def _linvt_ok(params: P.GPRParams) -> bool:
    """Tiny-noise gate for the fused-path triangular inverse, decided when the cache is
    built: with a noise/signal ratio below 1e-5 the true posterior variance near the data
    is below the fused kernel's absolute variance contract, so ``LinvT`` is not built
    (saving its O(C³) cost too) and prediction takes the exact path."""
    noise = float(params.noise_variance)
    host_read("gpr.linvt_gate")
    variance = float(params.kernel.variance)
    host_read("gpr.linvt_gate")
    return noise / max(variance, 1e-30) >= 1e-5


class GaussianProcessRegression:
    """Exact GPR with a Gaussian likelihood and a constant mean function.

    Implements ``TrainableProbabilisticModel``, ``SupportsPredictJoint``,
    ``SupportsPredictY``, ``SupportsGetKernel`` / ``ObservationNoise`` / ``InternalData`` /
    ``MeanFunction``, ``SupportsCovarianceBetweenPoints``, ``FastUpdateModel``,
    ``HasTrajectorySampler`` and ``HasReparamSampler``."""

    def __init__(
        self,
        params: P.GPRParams,
        dataset: Dataset,
        *,
        num_kernel_samples: int = 10,
        train_noise: bool = True,
        max_optimize_iters: int = 100,
        num_rff_features: int = 1000,
        optimize_generator: Optional[torch.Generator] = None,
        priors: Optional[GPPriors] = None,
    ):
        self._params = params
        self._dataset = dataset
        self._num_kernel_samples = num_kernel_samples
        self._train_noise = train_noise
        self._max_optimize_iters = max_optimize_iters
        self._num_rff_features = num_rff_features
        self._priors = priors
        if optimize_generator is None:
            optimize_generator = torch.Generator(device=dataset.device).manual_seed(0)
        self._generator = optimize_generator
        self._cache = self._build_cache()

    def _build_cache(self) -> P.GPRCache:
        global cache_builds
        cache_builds += 1
        ds = self._dataset
        with span("posterior.build_cache", n=len(ds)):
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

    def get_kernel(self) -> Stationary:
        return self._params.kernel

    def get_observation_noise(self) -> torch.Tensor:
        return self._params.noise_variance

    def get_internal_data(self) -> Dataset:
        return self._dataset

    def get_mean_function(self) -> Callable[[torch.Tensor], torch.Tensor]:
        c = self._params.mean_constant
        return lambda x: c.expand(x.shape[:-1] + (1,))

    @property
    def num_rff_features(self) -> int:
        return self._num_rff_features

    def predict(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return P.predict_f(self._params, self._cache, query_points)

    def predict_joint(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return P.predict_joint(self._params, self._cache, query_points)

    def predict_y(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return P.predict_y(self._params, self._cache, query_points)

    def sample(
        self, generator: Optional[torch.Generator], query_points: torch.Tensor, num_samples: int
    ) -> torch.Tensor:
        """Joint posterior samples ``[..., S, B, L]`` at ``[..., B, D]``."""
        return P.sample_joint(generator, self._params, self._cache, query_points, num_samples)

    def covariance_between_points(
        self, query_points_1: torch.Tensor, query_points_2: torch.Tensor
    ) -> torch.Tensor:
        return P.covariance_between_points(
            self._params, self._cache, query_points_1, query_points_2
        )

    # -- fast updates (fantasizing) ---------------------------------------------------

    def conditional_predict_f(
        self, query_points: torch.Tensor, additional_data: Dataset
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return P.conditional_predict_f(
            self._params, self._cache, query_points, *additional_data.astuple()
        )

    def conditional_predict_joint(
        self, query_points: torch.Tensor, additional_data: Dataset
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return P.conditional_predict_joint(
            self._params, self._cache, query_points, *additional_data.astuple()
        )

    def conditional_predict_y(
        self, query_points: torch.Tensor, additional_data: Dataset
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return P.conditional_predict_y(
            self._params, self._cache, query_points, *additional_data.astuple()
        )

    def conditional_predict_f_sample(
        self,
        generator: Optional[torch.Generator],
        query_points: torch.Tensor,
        additional_data: Dataset,
        num_samples: int,
    ) -> torch.Tensor:
        return P.conditional_predict_f_sample(
            generator, self._params, self._cache, query_points, *additional_data.astuple(),
            num_samples,
        )

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
        """Multi-start training of the hyperparameters on ``dataset``. Under a global mesh
        (:mod:`trieste_tpu_torch.parallel`) the restarts are rounded up to a multiple of
        its size and sharded over it."""
        result = fit_gpr(
            self._generator, self._params, dataset.query_points, dataset.observations,
            dataset.mask, num_starts=round_to_mesh(self._num_kernel_samples),
            train_noise=self._train_noise, max_iters=self._max_optimize_iters,
            pool_sharding=current_pool_sharding(), priors=self._priors,
        )
        self._params = result.params
        self._dataset = dataset
        self._cache = self._build_cache()
        return result

    def reparam_sampler(self, num_samples: int) -> ReparametrizationSampler:
        from .sampler import BatchReparametrizationSampler

        return BatchReparametrizationSampler(num_samples, self)

    def trajectory_sampler(self) -> TrajectorySampler:
        from .sampler import RandomFourierFeatureTrajectorySampler

        return RandomFourierFeatureTrajectorySampler(self, self._num_rff_features)

    def log(self, dataset: Optional[Dataset] = None) -> None:
        """Queue the hyperparameters (the lengthscales as one vector) and, given a dataset,
        the accuracy of the predictions over it, as summaries read at the loop's per-step
        flush."""
        from ...logging import deferred_scalar, deferred_scalar_vector, get_tensorboard_writer

        if get_tensorboard_writer() is None:
            return
        params = self._params
        deferred_scalar("kernel.variance", params.kernel.variance)
        ls = params.kernel.lengthscales
        deferred_scalar_vector([f"kernel.lengthscale[{i}]" for i in range(ls.shape[0])], ls)
        deferred_scalar("likelihood.variance", params.noise_variance)
        if dataset is not None:
            from ..utils import write_summary_data_based_metrics

            write_summary_data_based_metrics(dataset, self)

    def __repr__(self) -> str:
        return (
            f"GaussianProcessRegression(kernel={self._params.kernel.kind}, "
            f"n={len(self._dataset)})"
        )
