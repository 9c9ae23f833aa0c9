"""The family ``build_gpr`` on the reference's side: the exact GP as the configuration's
``model`` states it, worked out again in plain PyTorch (:mod:`benchmarks.reference.gp`)
from the program's hyperparameters, which are the thing judged.

A family's reference gives the check three things, found by the builder's name:

- :func:`episode`: what an episode fixes before any fit, here the likelihood's variance
  and the LogNormal priors from the episode's initial observations;
- :func:`posterior`: the posterior of the data at the program's hyperparameters, in a
  given precision, with the ``scale`` the gaps of scores are measured in (the signal's
  standard deviation) and the trajectories of :meth:`~benchmarks.reference.gp.Posterior.trajectory`;
- :func:`fit_gap`: the number reported as ``fit_gap``.

Nothing of the program is imported; the hyperparameters are read as attributes."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from benchmarks.reference import gp as R
from benchmarks.reference.precision import Precision

Context = Tuple[float, R.Priors]  # the fixed noise and the priors of one episode


def episode(config: Dict[str, Any], Y0: torch.Tensor, lower: torch.Tensor,
            upper: torch.Tensor) -> Context:
    """The fixed noise (the configuration's, or the default from ``Y0``) and the priors of
    a model built on the episode's initial observations ``Y0``."""
    m = config["model"]
    noise, priors = R.default_noise_and_priors(
        Y0, upper - lower, lower.shape[0], m["lengthscale_factor"], m["signal_noise_ratio"],
        m["prior_scale"], m["squeeze_log_range"], m.get("likelihood_variance"))
    priors = R.Priors(priors.var_loc, priors.ls_loc.to(lower.device), priors.scale,
                      priors.squeeze)
    return noise, priors


def hyper(config: Dict[str, Any], context: Context, theta) -> R.Hyper:
    """The program's hyperparameters (its kernel's variance and lengthscales and its mean
    constant) as the reference's, in float64."""
    k = theta.kernel
    return R.Hyper(k.variance.double(), k.lengthscales.double().reshape(-1),
                   theta.mean_constant.double(), context[0], config["model"]["cholesky_jitter"])


def posterior(config: Dict[str, Any], context: Context, X: torch.Tensor, Y: torch.Tensor,
              theta, prec: Precision) -> R.Posterior:
    """The exact posterior of ``X [n, D]``, ``Y [n, 1]`` (float64) at ``theta``, in
    ``prec``."""
    return R.Posterior(X, Y, hyper(config, context, theta), prec)


def fit_gap(config: Dict[str, Any], context: Context, X: torch.Tensor, Y: torch.Tensor,
            theta, prec: Optional[Precision] = None) -> float:
    """How far the MAP objective (negative log marginal likelihood and log priors, in
    float64) at the program's fitted hyperparameters lies above the optimum that a float64
    fit reaches from them, per training point: zero at a MAP optimum. With ``prec``, the
    same of where a fit in that precision ends from those hyperparameters instead (the
    control)."""
    _, priors = context
    h = hyper(config, context, theta)
    u = R.pack(h)
    if prec is not None:
        u = R.fit_local(u, X, Y, h, priors, prec)
        if not bool(torch.isfinite(u).all()):
            return math.inf
    return R.fit_gap(u, X, Y, h, priors)
