"""Observation likelihoods for the variational GP (counterpart of
:mod:`trieste_tpu.models.gp.likelihoods`).

Each likelihood is a small frozen dataclass carried in :class:`~.vgp.VGPParams`; the
Gaussian one holds a trainable ``variance`` tensor. Each provides:

- ``log_prob(f, y)``: pointwise ``log p(y | f)``;
- ``variational_expectations(mean, var, y)``: ``E_{N(f | mean, var)}[log p(y | f)]``, in
  closed form where there is one, else by 20-point Gauss-Hermite quadrature;
- ``predict_y(mean, var)``: the observation's moments from the latent ones.

``mean``, ``var`` and ``y`` are ``[..., 1]`` columns; the expectations match them.

>>> g = GaussianLikelihood(variance=torch.tensor(0.25, dtype=torch.float64))
>>> mean, var = g.predict_y(torch.tensor([[1.0]], dtype=torch.float64),
...                         torch.tensor([[0.1]], dtype=torch.float64))
>>> round(float(var[0, 0]), 12)  # the latent variance plus the observation noise
0.35
>>> prob, _ = BernoulliLikelihood().predict_y(torch.zeros(1, 1), torch.ones(1, 1))
>>> float(prob[0, 0])  # Phi(0 / sqrt(2))
0.5
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

# the probabilists' Gauss-Hermite nodes and weights, normalized for N(0, 1) expectations
_GH_X, _GH_W = np.polynomial.hermite_e.hermegauss(20)
_GH_W = _GH_W / np.sqrt(2.0 * np.pi)


@functools.lru_cache(maxsize=None)
def _gauss_hermite(dtype: torch.dtype, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The nodes and weights on ``device``, copied there once."""
    return (torch.as_tensor(_GH_X, dtype=dtype, device=device),
            torch.as_tensor(_GH_W, dtype=dtype, device=device))


def gauss_hermite_expectation(
    log_prob: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    mean: torch.Tensor,
    var: torch.Tensor,
    y: torch.Tensor,
) -> torch.Tensor:
    """``E_{N(f | mean, var)}[log_prob(f, y)]`` by 20-point Gauss-Hermite quadrature."""
    x, w = _gauss_hermite(mean.dtype, mean.device)
    std = torch.sqrt(torch.clamp_min(var, 1e-24))
    nodes = mean[..., None] + std[..., None] * x  # [..., 1, Q]
    return torch.sum(log_prob(nodes, y[..., None]) * w, dim=-1)


class _Likelihood:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class BernoulliLikelihood(_Likelihood):
    """Probit-Bernoulli: ``p(y = 1 | f) = Φ(f)``."""

    def log_prob(self, f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.special.log_ndtr((2.0 * y - 1.0) * f), -1e3, 0.0)

    def variational_expectations(self, mean, var, y) -> torch.Tensor:
        return gauss_hermite_expectation(self.log_prob, mean, var, y)

    def predict_y(self, mean: torch.Tensor, var: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        p = torch.special.ndtr(mean / torch.sqrt(1.0 + var))
        return p, p * (1.0 - p)


@dataclass(frozen=True)
class GaussianLikelihood(_Likelihood):
    """Gaussian observation noise with a trainable ``variance``; closed-form variational
    expectations."""

    variance: torch.Tensor

    def log_prob(self, f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return -0.5 * (math.log(2.0 * math.pi) + torch.log(self.variance)
                       + torch.square(y - f) / self.variance)

    def variational_expectations(self, mean, var, y) -> torch.Tensor:
        s2 = self.variance
        return -0.5 * (torch.log(2.0 * math.pi * s2) + (torch.square(y - mean) + var) / s2)

    def predict_y(self, mean: torch.Tensor, var: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return mean, var + self.variance


@dataclass(frozen=True)
class PoissonLikelihood(_Likelihood):
    """Poisson counts with the log link ``rate = exp(f)``; closed-form variational
    expectations ``y·m − exp(m + v/2) − log y!``."""

    def log_prob(self, f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return y * f - torch.exp(f) - torch.lgamma(y + 1.0)

    def variational_expectations(self, mean, var, y) -> torch.Tensor:
        return y * mean - torch.exp(mean + 0.5 * var) - torch.lgamma(y + 1.0)

    def predict_y(self, mean: torch.Tensor, var: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # the moments of a log-Gaussian-mixed Poisson
        rate = torch.exp(mean + 0.5 * var)
        return rate, rate + (torch.exp(var) - 1.0) * torch.exp(2.0 * mean + var)
