"""Carry state across from the JAX package by way of numpy.

The port never imports JAX: a caller takes ``np.asarray`` of each JAX leaf and hands the
arrays here, so that both packages compute on the same parameters and data.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .data import Dataset
from .models.gp.posterior import GPRParams
from .models.gp.priors import GPPriors
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
