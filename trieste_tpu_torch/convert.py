"""Carry state across from the JAX package by way of numpy.

The port never imports JAX: a caller takes ``np.asarray`` of each JAX leaf and hands the
arrays here, so that both packages compute on the same parameters and data.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

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
from .models.gp.posterior import GPRCache, GPRParams
from .models.gp.priors import GPPriors
from .models.gp.sampler import DecoupledTrajectory, FourierFeatures, RFFTrajectory
from .ops.kernels import stationary

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
