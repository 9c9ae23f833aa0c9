"""Exact Gaussian-process regression (counterpart of :mod:`trieste_tpu.models.gp`)."""
from .builders import build_gpr, default_gpr_params
from .gpr import GaussianProcessRegression
from .posterior import GPRCache, GPRParams
from .priors import GPPriors
