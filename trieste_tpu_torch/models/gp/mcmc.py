"""Fully-Bayesian exact GP: HMC over the hyperparameters (counterpart of
:mod:`trieste_tpu.models.gp.mcmc`).

``optimize`` samples the hyperparameters' posterior (the marginal likelihood times an
independent Gaussian prior on the log parameters) with lockstep HMC chains
(:mod:`trieste_tpu_torch.ops.hmc`), in the data's dtype, and keeps a thinned stack of
``S`` samples. Every prediction is the mixture over that stack: the posterior caches are
one batch of ``S`` Cholesky factors, and the mixture's moments follow from the law of
total variance. The mixture never goes through the fused prediction kernel, which takes
one set of hyperparameters per launch; it predicts by the exact path, over chunks of
samples whose ``[s, N, C]`` cross-covariance stays under :data:`MIXTURE_CHUNK_BYTES`.

Every function that draws is split in two: a small one that takes its base variables from
a ``torch.Generator`` and a pure function of them (``*_from_draws``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...data import Dataset
from ...ops.hmc import HMCResults, draw_hmc, hmc_sample_from_draws
from ...ops.kernels import Stationary, gram
from ...ops.linalg import solve_lower
from ...parallel import gather_rows, local_slice, round_to_mesh, sharding_mesh
from ...utils.misc import flatten_leading_dims, jitter_for, standard_normal
from ..interfaces import ReparametrizationSampler, TrajectorySampler
from . import posterior as P
from .posterior import _joint_samples
from .training import pack_params, unpack_params

PRIOR_SCALE = 2.0
"""Scale of the Gaussian prior on the log hyperparameters around the template's."""

MIXTURE_CHUNK_BYTES = 2**30
"""Most bytes of one ``[s, N, C]`` cross-covariance of a mixture prediction: a larger
prediction accumulates the mixture's moments over chunks of samples."""


def _log_posterior(
    u: torch.Tensor, u0: torch.Tensor, template: P.GPRParams, X: torch.Tensor, Y: torch.Tensor,
    mask: torch.Tensor, prior_scale: float,
) -> torch.Tensor:
    """The log marginal likelihood at ``u [..., U]`` (the noise trained) plus an independent
    Gaussian prior of scale ``prior_scale`` around ``u0 = pack_params(template)``: ``[...]``."""
    params = unpack_params(u, template, train_noise=True)
    mll = P.log_marginal_likelihood(params, X, Y, mask)
    return mll - 0.5 * torch.sum(torch.square((u - u0) / prior_scale), dim=-1)


def _draw_chains(
    generator: Optional[torch.Generator], num_chains: int, num_transitions: int, u0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chains' start jitter ``0.5·N(0, 1) [chains, U]``, momenta and uniforms."""
    jitter = 0.5 * standard_normal(generator, (num_chains, u0.shape[0]), u0)
    return (jitter,) + draw_hmc(generator, num_transitions, num_chains, u0.shape[0], u0)


def _run_chains_from_draws(
    template: P.GPRParams, X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor,
    u0: torch.Tensor, jitter: torch.Tensor, momenta: torch.Tensor, uniforms: torch.Tensor,
    num_warmup: int,
) -> HMCResults:
    """HMC over the log posterior from ``u0 + jitter``, one chain per row of ``jitter``."""

    def log_prob(u: torch.Tensor) -> torch.Tensor:
        return _log_posterior(u, u0, template, X, Y, mask, PRIOR_SCALE)

    return hmc_sample_from_draws(log_prob, u0[None, :] + jitter, momenta, uniforms,
                                 num_warmup=num_warmup)


def _thin(samples: torch.Tensor, num_retained: int) -> torch.Tensor:
    """``num_retained`` evenly strided rows of the chain-major ``[chains·S, U]`` samples."""
    flat = samples.reshape(-1, samples.shape[-1])
    take = min(num_retained, flat.shape[0])
    stride = max(flat.shape[0] // take, 1)
    return flat[::stride][:take]


def _select(params: P.GPRParams, index) -> P.GPRParams:
    """The samples ``index`` (a slice or an index tensor) of a stacked ``params``."""
    kernel = params.kernel.replace(variance=params.kernel.variance[index],
                                   lengthscales=params.kernel.lengthscales[index])
    return P.GPRParams(kernel, params.noise_variance[index], params.mean_constant[index])


def _stacked_predict(
    params: P.GPRParams, L: torch.Tensor, alpha: torch.Tensor, cache: P.GPRCache,
    flat: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each sample's exact marginal posterior at ``flat [N, D]``: ``([s, N, P], [s, N])``
    for ``params`` stacked over ``[s]`` with factors ``L [s, C, C]`` and ``alpha [s, C, P]``."""
    Kxn = gram(params.kernel, flat, cache.X) * cache.mask.to(flat.dtype)  # [s, N, C]
    mean = Kxn @ alpha + params.mean_constant[:, None, None]
    v = solve_lower(L, Kxn.transpose(-1, -2))  # [s, C, N]
    var = params.kernel.variance[:, None] - torch.sum(torch.square(v), dim=-2)
    return mean, torch.clamp_min(var, 1e-24)


def _mixture_predict(
    params_stack: P.GPRParams, caches_stack: P.GPRCache, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mixture's marginal moments over the ``S`` stacked samples, ``[..., D] ->
    ([..., P], [..., P])``: the mean of the means, and the mean of ``var + mean²`` less the
    squared mixture mean, floored at 1e-24."""
    flat, unflatten = flatten_leading_dims(x, output_dims=2)
    S, C = caches_stack.L.shape[0], caches_stack.X.shape[0]
    per_sample = flat.shape[0] * C * flat.element_size()
    step = max(1, min(S, MIXTURE_CHUNK_BYTES // max(per_sample, 1)))
    first = second = 0.0
    for s in range(0, S, step):
        chunk = slice(s, s + step)
        mean, var = _stacked_predict(_select(params_stack, chunk), caches_stack.L[chunk],
                                     caches_stack.alpha[chunk], caches_stack, flat)
        first = first + mean.sum(dim=0)
        second = second + (var[..., None] + torch.square(mean)).sum(dim=0)
    mix_mean = first / S
    mix_var = torch.clamp_min(second / S - torch.square(mix_mean), 1e-24)
    return unflatten(mix_mean), unflatten(mix_var)


def _sample_from_draws(
    params_stack: P.GPRParams, caches_stack: P.GPRCache, query_points: torch.Tensor,
    index: torch.Tensor, eps: torch.Tensor,
) -> torch.Tensor:
    """Joint draws ``[..., S, B, P]`` at ``[..., B, D]``: draw s under the hyperparameter
    sample ``index[s]``, from standard normals ``eps [..., S, P, 1, B]``. The joint
    covariance is assembled and factorized in float64, as in
    :func:`~trieste_tpu_torch.models.gp.posterior.sample_joint_from_eps`."""
    dtype = query_points.dtype
    f64 = torch.float64
    p = _select(params_stack, index)
    kernel = p.kernel.replace(variance=p.kernel.variance.to(f64),
                              lengthscales=p.kernel.lengthscales.to(f64))
    x = query_points.to(f64)[..., None, :, :]  # [..., 1, B, D]: broadcast over the draws
    X = caches_stack.X.to(f64)
    Kxn = gram(kernel, x, X) * caches_stack.mask.to(f64)  # [..., S, B, C]
    mean = Kxn @ caches_stack.alpha[index].to(f64) + p.mean_constant.to(f64)[:, None, None]
    v = solve_lower(caches_stack.L[index].to(f64), Kxn.transpose(-1, -2))  # [..., S, C, B]
    cov = gram(kernel, x) - v.transpose(-1, -2) @ v  # [..., S, B, B]
    cov = cov[..., None, :, :].expand(cov.shape[:-2] + (mean.shape[-1],) + cov.shape[-2:])
    draws = _joint_samples(mean, cov, eps.to(f64), jitter_for(dtype))  # [..., S, 1, B, P]
    return draws[..., 0, :, :].to(dtype)


class GaussianProcessRegressionMCMC:
    """Exact GPR with fully-Bayesian hyperparameters sampled by HMC.

    ``optimize`` replaces maximum-likelihood training with posterior sampling; every
    prediction marginalizes over the retained samples. Implements
    ``TrainableProbabilisticModel``, ``SupportsPredictY``, ``SupportsGetKernel`` (the mean
    kernel over samples), ``SupportsGetObservationNoise`` (the mean noise),
    ``SupportsGetInternalData``, ``HasTrajectorySampler`` and ``HasReparamSampler``."""

    def __init__(
        self,
        params: P.GPRParams,
        dataset: Dataset,
        *,
        num_chains: int = 4,
        num_samples_per_chain: int = 25,
        num_warmup: int = 100,
        num_retained: int = 20,
        optimize_generator: Optional[torch.Generator] = None,
    ):
        self._template = params
        self._dataset = dataset
        self._num_chains = num_chains
        self._num_samples_per_chain = num_samples_per_chain
        self._num_warmup = num_warmup
        self._num_retained = num_retained
        if optimize_generator is None:
            optimize_generator = torch.Generator(device=dataset.device).manual_seed(0)
        self._generator = optimize_generator
        # a one-sample "mixture" at the initial parameters until the first optimize
        self._params_stack = _select(params, None)
        self._refresh_caches()

    def _refresh_caches(self) -> None:
        ds = self._dataset
        self._caches_stack = P.build_cache(
            self._params_stack, ds.query_points, ds.observations, ds.mask, with_linvt=False
        )

    @property
    def params_stack(self) -> P.GPRParams:
        """The retained hyperparameter samples, stacked on a leading ``[S]`` axis."""
        return self._params_stack

    @params_stack.setter
    def params_stack(self, params_stack: P.GPRParams) -> None:
        """Replace the samples and refresh their posterior caches."""
        self._params_stack = params_stack
        self._refresh_caches()

    @property
    def posterior_caches(self) -> P.GPRCache:
        """The samples' posterior caches: ``L [S, C, C]`` and ``alpha [S, C, P]``."""
        return self._caches_stack

    @property
    def num_hyper_samples(self) -> int:
        return self._params_stack.noise_variance.shape[0]

    def get_internal_data(self) -> Dataset:
        return self._dataset

    def get_kernel(self) -> Stationary:
        kernel = self._params_stack.kernel
        return kernel.replace(variance=kernel.variance.mean(dim=0),
                              lengthscales=kernel.lengthscales.mean(dim=0))

    def get_observation_noise(self) -> torch.Tensor:
        return self._params_stack.noise_variance.mean()

    def predict(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return _mixture_predict(self._params_stack, self._caches_stack, query_points)

    def predict_y(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, var = self.predict(query_points)
        return mean, var + self.get_observation_noise()

    def sample(
        self, generator: Optional[torch.Generator], query_points: torch.Tensor, num_samples: int
    ) -> torch.Tensor:
        """Joint samples ``[..., S, B, P]`` at ``[..., B, D]``: each draw takes a uniformly
        chosen hyperparameter sample, then one joint posterior draw under it."""
        like = query_points
        index = torch.randint(0, self.num_hyper_samples, (num_samples,), generator=generator,
                              device=like.device)
        P_ = self._caches_stack.alpha.shape[-1]
        eps = standard_normal(
            generator, query_points.shape[:-2] + (num_samples, P_, 1, query_points.shape[-2]), like
        )
        return _sample_from_draws(self._params_stack, self._caches_stack, query_points, index, eps)

    def update(self, dataset: Dataset) -> None:
        self._dataset = dataset
        self._refresh_caches()

    def optimize(self, dataset: Dataset) -> HMCResults:
        """Run the chains on ``dataset`` and keep a thinned stack of their samples. Under a
        global mesh the chains are rounded up to a multiple of its size: every rank draws
        them all, runs its block (each chain adapts its own step size, so a block runs as
        it would among all) and gathers the results."""
        self._dataset = dataset
        u0 = pack_params(self._template, train_noise=True)
        num_chains = round_to_mesh(self._num_chains)
        jitter, momenta, uniforms = _draw_chains(
            self._generator, num_chains, self._num_warmup + self._num_samples_per_chain, u0
        )
        mesh = sharding_mesh()
        if mesh is not None:
            block = local_slice(num_chains, mesh)
            jitter, momenta, uniforms = jitter[block], momenta[:, block], uniforms[:, block]
        results = _run_chains_from_draws(
            self._template, dataset.query_points, dataset.observations, dataset.mask, u0,
            jitter, momenta, uniforms, self._num_warmup,
        )
        if mesh is not None:
            results = HMCResults(*(gather_rows(t, mesh) for t in results))
        self._params_stack = unpack_params(
            _thin(results.samples, self._num_retained), self._template, train_noise=True
        )
        self._refresh_caches()
        return results

    def trajectory_sampler(self) -> TrajectorySampler:
        return _MCMCTrajectorySampler(self)

    def reparam_sampler(self, num_samples: int) -> ReparametrizationSampler:
        from .sampler import IndependentReparametrizationSampler

        return IndependentReparametrizationSampler(num_samples, self)

    def log(self, dataset: Optional[Dataset] = None) -> None:
        """Nothing is logged, as in the JAX package."""

    def __repr__(self) -> str:
        return f"GaussianProcessRegressionMCMC(S={self.num_hyper_samples})"


class _MCMCTrajectorySampler(TrajectorySampler):
    """Decoupled trajectories under one uniformly chosen hyperparameter sample."""

    def __init__(self, model: GaussianProcessRegressionMCMC, num_features: int = 1000):
        super().__init__(model)
        self._num_features = num_features

    def get_trajectory(self, generator: Optional[torch.Generator], batch_size: int = 1):
        from .gpr import GaussianProcessRegression
        from .sampler import DecoupledTrajectorySampler

        model: GaussianProcessRegressionMCMC = self._model
        data = model.get_internal_data()
        index = int(torch.randint(0, model.num_hyper_samples, (), generator=generator,
                                  device=data.device))
        params = _select(model.params_stack, index)
        single = GaussianProcessRegression(params, data)
        return DecoupledTrajectorySampler(single, self._num_features).get_trajectory(
            generator, batch_size
        )


def build_gpr_mcmc(
    dataset: Dataset,
    search_space,
    *,
    kernel_kind: str = "matern52",
    likelihood_variance: Optional[float] = None,
    num_chains: int = 4,
    num_samples_per_chain: int = 25,
    num_warmup: int = 100,
    num_retained: int = 20,
    optimize_generator: Optional[torch.Generator] = None,
) -> GaussianProcessRegressionMCMC:
    """A fully-Bayesian GPR whose prior is centred on :func:`default_gpr_params`."""
    from .builders import default_gpr_params

    params = default_gpr_params(
        dataset, search_space, kernel_kind=kernel_kind, likelihood_variance=likelihood_variance
    )
    return GaussianProcessRegressionMCMC(
        params, dataset, num_chains=num_chains, num_samples_per_chain=num_samples_per_chain,
        num_warmup=num_warmup, num_retained=num_retained, optimize_generator=optimize_generator,
    )
