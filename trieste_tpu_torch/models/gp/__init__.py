"""Gaussian-process models (counterpart of :mod:`trieste_tpu.models.gp`): the exact GP and
the sparse SGPR and SVGP with their inducing-point selectors."""
from .builders import (
    MAX_NUM_INDUCING_POINTS,
    NUM_INDUCING_POINTS_PER_DIM,
    build_gpr,
    build_sgpr,
    build_svgp,
    default_gpr_params,
)
from .gpr import GaussianProcessRegression
from .inducing_points import (
    ConditionalImprovementReduction,
    ConditionalVarianceReduction,
    DPPInducingPointSelector,
    InducingPointSelector,
    KMeansInducingPointSelector,
    ModelBasedImprovementQualityFunction,
    RandomSubSampleInducingPointSelector,
    UniformInducingPointSelector,
    UnitQualityFunction,
    greedy_inference_dpp,
)
from .posterior import GPRCache, GPRParams
from .priors import GPPriors
from .sparse import (
    SGPRCache,
    SGPRParams,
    SparseGaussianProcessRegression,
    SparseVariational,
    SVGPParams,
)
