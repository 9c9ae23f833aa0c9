"""Carry state across from the JAX package by way of numpy.

The port never imports JAX: a caller takes ``np.asarray`` of each JAX leaf and hands the
arrays here, so that both packages compute on the same parameters and data.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Sequence, Tuple, Type, Union

import numpy as np
import torch

from .acquisition.rule import AsynchronousRuleState
from .acquisition.trust_region import (
    BatchTrustRegionState,
    SingleObjectiveTrustRegionBox,
    SingleObjectiveTrustRegionDiscrete,
    TREGOBox,
    TURBOBox,
    UpdatableTrustRegion,
    UpdatableTrustRegionBox,
    UpdatableTrustRegionDiscrete,
    UpdatableTrustRegionProduct,
)
from .data import Dataset
from .models.deepgp.deep_gp import DGPLayerParams, DGPParams
from .models.ensembles.deep_ensemble import DeepEnsembleParams, GaussianMLP
from .models.gp.gpr import GaussianProcessRegression
from .models.gp.mcmc import GaussianProcessRegressionMCMC
from .models.gp.likelihoods import BernoulliLikelihood, GaussianLikelihood, PoissonLikelihood
from .models.gp.multifidelity import (
    MultifidelityAutoregressive,
    MultifidelityNonlinearAutoregressive,
)
from .models.gp.posterior import GPRCache, GPRParams
from .models.gp.priors import GPPriors
from .models.gp.sampler import DecoupledTrajectory, FourierFeatures, RFFTrajectory
from .models.gp.sparse import SGPRParams, SVGPParams
from .models.gp.vgp import VGPParams
from .models.interfaces import ModelStack, TrainableModelStack
from .ops.kernels import stationary
from .space import Box, Constraint, LinearConstraint

Device = Union[str, torch.device]


def _tensor(a, device: Device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device, dtype=dtype)  # a copy: JAX's views are read-only


def gpr_params_from_numpy(
    kind: str,
    variance,
    lengthscales,
    noise_variance,
    mean_constant,
    *,
    device: Device = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> GPRParams:
    """:class:`GPRParams` from numpy values; a scalar lengthscale becomes shape ``[1]``."""
    variance = _tensor(variance, device, dtype)
    return GPRParams(
        kernel=stationary(kind, variance, _tensor(lengthscales, device, dtype),
                          dtype=variance.dtype, device=device),
        noise_variance=_tensor(noise_variance, device, variance.dtype),
        mean_constant=_tensor(mean_constant, device, variance.dtype),
    )


def gpr_mcmc_from_numpy(
    template: Mapping[str, Any],
    params_stack: Mapping[str, Any],
    dataset: Mapping[str, Any],
    *,
    device: Device = "cuda",
    dtype: Optional[torch.dtype] = None,
    **model_kwargs,
) -> GaussianProcessRegressionMCMC:
    """A fully-Bayesian GPR from numpy: its prior's ``template`` and its stacked samples
    ``params_stack`` (leading ``[S]`` on every value) as keyword arguments of
    :func:`gpr_params_from_numpy`, ``dataset`` those of :func:`dataset_from_numpy`;
    ``model_kwargs`` go to :class:`GaussianProcessRegressionMCMC`."""
    model = GaussianProcessRegressionMCMC(
        gpr_params_from_numpy(**template, device=device, dtype=dtype),
        dataset_from_numpy(**dataset, device=device, dtype=dtype),
        **model_kwargs,
    )
    model.params_stack = gpr_params_from_numpy(**params_stack, device=device, dtype=dtype)
    return model


def sgpr_params_from_numpy(
    kind: str,
    variance,
    lengthscales,
    noise_variance,
    mean_constant,
    inducing_points,
    *,
    device: Device = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> SGPRParams:
    """:class:`SGPRParams` from numpy values (inducing points ``[M, D]``)."""
    base = gpr_params_from_numpy(kind, variance, lengthscales, noise_variance, mean_constant,
                                 device=device, dtype=dtype)
    return SGPRParams(kernel=base.kernel, noise_variance=base.noise_variance,
                      mean_constant=base.mean_constant,
                      inducing_points=_tensor(inducing_points, device, base.kernel.variance.dtype))


def svgp_params_from_numpy(
    kind: str,
    variance,
    lengthscales,
    noise_variance,
    mean_constant,
    inducing_points,
    q_mu,
    q_sqrt,
    *,
    device: Device = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> SVGPParams:
    """:class:`SVGPParams` from numpy values (``q_mu [M, P]``, ``q_sqrt [P, M, M]``)."""
    base = sgpr_params_from_numpy(kind, variance, lengthscales, noise_variance, mean_constant,
                                  inducing_points, device=device, dtype=dtype)
    like = base.inducing_points
    return SVGPParams(kernel=base.kernel, noise_variance=base.noise_variance,
                      mean_constant=base.mean_constant, inducing_points=like,
                      q_mu=_tensor(q_mu, device, like.dtype), q_sqrt=_tensor(q_sqrt, device, like.dtype))


def vgp_params_from_numpy(
    kind: str,
    variance,
    lengthscales,
    mean_constant,
    q_mu,
    q_sqrt,
    *,
    likelihood: str = "bernoulli",
    likelihood_variance=None,
    device: Device = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> VGPParams:
    """:class:`VGPParams` from numpy values, the likelihood named ``bernoulli``,
    ``gaussian`` (with ``likelihood_variance``) or ``poisson``."""
    base = gpr_params_from_numpy(kind, variance, lengthscales, 0.0, mean_constant,
                                 device=device, dtype=dtype)
    dtype = base.kernel.variance.dtype
    likelihoods = {
        "bernoulli": BernoulliLikelihood,
        "poisson": PoissonLikelihood,
        "gaussian": lambda: GaussianLikelihood(_tensor(likelihood_variance, device, dtype)),
    }
    return VGPParams(
        kernel=base.kernel, mean_constant=base.mean_constant,
        q_mu=_tensor(q_mu, device, dtype), q_sqrt=_tensor(q_sqrt, device, dtype),
        likelihood=likelihoods[likelihood](),
    )



def deep_ensemble_from_numpy(
    member_params: Mapping[str, Mapping[str, Any]],
    x_mean,
    x_std,
    y_mean,
    y_std,
    *,
    device: Device = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> DeepEnsembleParams:
    """:class:`DeepEnsembleParams` from numpy values: ``member_params`` is the JAX
    package's flax tree, ``{"Dense_i": {"kernel": [E, d_in, d_out], "bias": [E, d_out]}}``
    with the hidden layers first and the two heads last, in flax's layout, which the port
    keeps; the normalization as it is. Everything takes ``dtype``, by default the
    normalization's (flax keeps float32 weights under x64, computing in float64)."""
    dtype = dtype or _tensor(x_mean, device, None).dtype
    names = sorted(member_params, key=lambda name: int(name.rsplit("_", 1)[1]))
    kernels = [_tensor(member_params[name]["kernel"], device, dtype) for name in names]
    return DeepEnsembleParams(
        member_params=GaussianMLP(
            kernels, [_tensor(member_params[name]["bias"], device, dtype) for name in names]
        ),
        x_mean=_tensor(x_mean, device, dtype), x_std=_tensor(x_std, device, dtype),
        y_mean=_tensor(y_mean, device, dtype), y_std=_tensor(y_std, device, dtype),
    )


def dgp_params_from_numpy(
    layers: Sequence[Mapping[str, Any]],
    noise_variance,
    mean_constant,
    *,
    device: Device = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> DGPParams:
    """:class:`DGPParams` from numpy values: each layer a mapping with the kernel's
    ``kind``, ``variance`` and ``lengthscales``, and ``inducing_points [M, d_in]``,
    ``q_mu [M, d_out]`` and ``q_sqrt [d_out, M, M]``."""
    out = []
    for layer in layers:
        variance = _tensor(layer["variance"], device, dtype)
        like = variance.dtype
        out.append(DGPLayerParams(
            kernel=stationary(layer["kind"], variance, _tensor(layer["lengthscales"], device, like),
                              dtype=like, device=device),
            inducing_points=_tensor(layer["inducing_points"], device, like),
            q_mu=_tensor(layer["q_mu"], device, like),
            q_sqrt=_tensor(layer["q_sqrt"], device, like),
        ))
    like = out[0].q_mu.dtype
    return DGPParams(tuple(out), _tensor(noise_variance, device, like),
                     _tensor(mean_constant, device, like))

def _fidelity_levels(
    levels: Sequence[Tuple[Mapping[str, Any], Mapping[str, Any]]], device: Device,
    dtype: Optional[torch.dtype], model_kwargs,
) -> list:
    return [
        GaussianProcessRegression(
            gpr_params_from_numpy(**params, device=device, dtype=dtype),
            dataset_from_numpy(**dataset, device=device, dtype=dtype),
            **model_kwargs,
        )
        for params, dataset in levels
    ]


def multifidelity_autoregressive_from_numpy(
    rho,
    levels: Sequence[Tuple[Mapping[str, Any], Mapping[str, Any]]],
    *,
    device: Device = "cuda",
    dtype: Optional[torch.dtype] = None,
    **model_kwargs,
) -> MultifidelityAutoregressive:
    """An AR(1) model from numpy: ``rho [S-1]`` and, per level, ``(params, dataset)``, the
    keyword arguments of :func:`gpr_params_from_numpy` and :func:`dataset_from_numpy` (a
    residual level's dataset holds its residuals); ``model_kwargs`` go to every
    :class:`GaussianProcessRegression`."""
    models = _fidelity_levels(levels, device, dtype, model_kwargs)
    return MultifidelityAutoregressive(models, rho=_tensor(rho, device, models[0].params.kernel.variance.dtype))


def multifidelity_nonlinear_autoregressive_from_numpy(
    levels: Sequence[Tuple[Mapping[str, Any], Mapping[str, Any]]],
    num_monte_carlo: int = 32,
    *,
    generator: Optional[torch.Generator] = None,
    device: Device = "cuda",
    dtype: Optional[torch.dtype] = None,
    **model_kwargs,
) -> MultifidelityNonlinearAutoregressive:
    """A NARGP model from numpy, its levels given as for
    :func:`multifidelity_autoregressive_from_numpy` (an upper level's inputs augmented)."""
    return MultifidelityNonlinearAutoregressive(
        _fidelity_levels(levels, device, dtype, model_kwargs), num_monte_carlo,
        generator=generator,
    )


def linear_constraint_from_numpy(A, lb, ub) -> LinearConstraint:
    """A :class:`LinearConstraint` from the numpy values of the JAX package's ``A``, ``lb``
    and ``ub`` (a box it is given to moves it to its own device and dtype)."""
    return LinearConstraint(np.array(A), np.array(lb), np.array(ub))


def box_from_numpy(
    lower,
    upper,
    constraints: Sequence[Constraint] = (),
    *,
    device: Device = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> Box:
    """A :class:`Box` from numpy bounds with the port's constraints (a nonlinear
    constraint's function cannot cross packages: its torch twin is written by hand)."""
    return Box(np.asarray(lower), np.asarray(upper), list(constraints), dtype=dtype, device=device)


def dataset_from_numpy(
    query_points,
    observations,
    num_points: int,
    capacity: Optional[int] = None,
    *,
    device: Device = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> Dataset:
    """A :class:`Dataset` from padded (or exact-size) numpy buffers and a count of valid
    rows, padded to ``capacity`` (default: the buffers' own length)."""
    qp = _tensor(query_points, device, dtype)
    obs = _tensor(observations, device, dtype)
    n = int(num_points)
    return Dataset.from_arrays(qp[:n], obs[:n], capacity=capacity or qp.shape[0])


def model_stack_from_numpy(
    members: Sequence[Tuple[Mapping[str, Any], Mapping[str, Any], int]],
    *,
    stack_type: Type[ModelStack] = TrainableModelStack,
    device: Device = "cuda",
    dtype: Optional[torch.dtype] = None,
    **model_kwargs,
) -> ModelStack:
    """A stack of exact GPs from numpy: each member is ``(params, dataset, event_size)``,
    with ``params`` the keyword arguments of :func:`gpr_params_from_numpy` and ``dataset``
    those of :func:`dataset_from_numpy`. ``stack_type`` picks the stack
    (:class:`TrainableModelStack`, or a joint, predict-y or reparam-sampler variant);
    ``model_kwargs`` go to every :class:`GaussianProcessRegression`."""
    return stack_type(*[
        (
            GaussianProcessRegression(
                gpr_params_from_numpy(**params, device=device, dtype=dtype),
                dataset_from_numpy(**dataset, device=device, dtype=dtype),
                **model_kwargs,
            ),
            int(event_size),
        )
        for params, dataset, event_size in members
    ])


def priors_from_numpy(
    ls_loc, var_loc, scale, *, device: Device = "cuda", dtype: Optional[torch.dtype] = None
) -> GPPriors:
    """:class:`GPPriors` from numpy values; a scalar ``ls_loc`` becomes shape ``[1]``."""
    return GPPriors(
        ls_loc=torch.atleast_1d(_tensor(ls_loc, device, dtype)),
        var_loc=_tensor(var_loc, device, dtype),
        scale=_tensor(scale, device, dtype),
    )


def fourier_features_from_numpy(
    W, b, variance, *, device: Device = "cuda", dtype: Optional[torch.dtype] = None
) -> FourierFeatures:
    """:class:`FourierFeatures` from the leaves of the JAX package's ``FourierFeatures``."""
    return FourierFeatures(
        W=_tensor(W, device, dtype), b=_tensor(b, device, dtype),
        variance=_tensor(variance, device, dtype),
    )


def rff_trajectory_from_numpy(
    mean_constant, W, b, variance, theta, *, device: Device = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> RFFTrajectory:
    """:class:`RFFTrajectory` from the leaves of the JAX package's ``RFFTrajectory``
    (its ``features`` given as ``W``, ``b`` and ``variance``)."""
    return RFFTrajectory(
        mean_constant=_tensor(mean_constant, device, dtype),
        features=fourier_features_from_numpy(W, b, variance, device=device, dtype=dtype),
        theta=_tensor(theta, device, dtype),
    )


def decoupled_trajectory_from_numpy(
    params: GPRParams, cache: GPRCache, W, b, variance, w, v, *, device: Device = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> DecoupledTrajectory:
    """:class:`DecoupledTrajectory` over the port's ``params`` and ``cache`` from the
    leaves of the JAX package's ``DecoupledTrajectory``."""
    return DecoupledTrajectory(
        params=params, cache=cache,
        features=fourier_features_from_numpy(W, b, variance, device=device, dtype=dtype),
        w=_tensor(w, device, dtype), v=_tensor(v, device, dtype),
    )


def asynchronous_rule_state_from_numpy(
    pending_points, *, device: Device = "cuda", dtype: Optional[torch.dtype] = None
) -> AsynchronousRuleState:
    """:class:`AsynchronousRuleState` from pending points ``[P, D]`` (``None``: none)."""
    if pending_points is None:
        return AsynchronousRuleState(None)
    return AsynchronousRuleState(_tensor(pending_points, device, dtype))


def _optional_tensor(a, like: torch.Tensor) -> Optional[torch.Tensor]:
    return None if a is None else _tensor(a, like.device, like.dtype)


def trust_region_box_state_from_numpy(
    region: UpdatableTrustRegionBox,
    lower,
    upper,
    *,
    location=None,
    eps=None,
    y_min: float = math.inf,
    needs_init: bool = False,
    region_initialized: bool = True,
    is_global: Optional[bool] = None,
    L: Optional[float] = None,
    success_counter: int = 0,
    failure_counter: int = 0,
) -> UpdatableTrustRegionBox:
    """Put a box region in a given state, in place, on its device and with its dtype:
    its bounds, and where the class has them its location, ``eps`` (or TuRBO's ``L`` and
    counters), the minimum it tracks, its flags and TREGO's phase. Returns the region."""
    region._set_bounds(np.asarray(lower), np.asarray(upper))
    like = region.lower
    if isinstance(region, SingleObjectiveTrustRegionBox):
        region.location = _optional_tensor(location, like)
        region.eps = _optional_tensor(eps, like)
        region._region_initialized = bool(region_initialized)
    if isinstance(region, TREGOBox) and is_global is not None:
        region._is_global = bool(is_global)
    if isinstance(region, TURBOBox):
        region.location = _optional_tensor(location, like)
        region.L = float(L if L is not None else region.L_init)
        region.success_counter = int(success_counter)
        region.failure_counter = int(failure_counter)
    region._y_min = float(y_min)
    region._needs_init = bool(needs_init)
    return region


def trust_region_discrete_state_from_numpy(
    region: UpdatableTrustRegionDiscrete,
    points,
    *,
    location=None,
    eps: Optional[float] = None,
    y_min: float = math.inf,
    needs_init: bool = False,
) -> UpdatableTrustRegionDiscrete:
    """Put a discrete region in a given state, in place: its points and, for
    :class:`SingleObjectiveTrustRegionDiscrete`, its location, ``eps``, minimum and flag."""
    like = region.global_search_space.points
    region._points = _tensor(points, like.device, like.dtype).reshape(-1, like.shape[-1])
    if isinstance(region, SingleObjectiveTrustRegionDiscrete):
        region.location = _optional_tensor(location, like)
        region.eps = float(eps if eps is not None else region._zeta)
        region._y_min = float(y_min)
        region._needs_init = bool(needs_init)
    return region


def batch_trust_region_state_from_regions(
    regions: Sequence[UpdatableTrustRegion],
) -> BatchTrustRegionState:
    """:class:`BatchTrustRegionState` over regions in the state given (product regions
    recompute their geometry from their members)."""
    for region in regions:
        if isinstance(region, UpdatableTrustRegionProduct):
            region._sync()
    return BatchTrustRegionState(tuple(regions))
