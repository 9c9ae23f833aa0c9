"""Gaussian-process models (counterpart of :mod:`trieste_tpu.models.gp`): the exact GP, the
sparse SGPR and SVGP with their inducing-point selectors, the variational GP with its
likelihoods, the fully-Bayesian GP and the multifidelity models."""
from .builders import (
    MAX_NUM_INDUCING_POINTS,
    NUM_INDUCING_POINTS_PER_DIM,
    build_gpr,
    build_sgpr,
    build_svgp,
    default_gpr_params,
)
from .gpr import GaussianProcessRegression
from .mcmc import GaussianProcessRegressionMCMC, build_gpr_mcmc
from .likelihoods import BernoulliLikelihood, GaussianLikelihood, PoissonLikelihood
from .multifidelity import (
    MultifidelityAutoregressive,
    MultifidelityNonlinearAutoregressive,
    build_multifidelity_autoregressive_models,
)
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
from .priors import GPPriors, default_priors, log_prior_density
from .sampler import (
    BatchReparametrizationSampler,
    DecoupledTrajectorySampler,
    IndependentReparametrizationSampler,
    RandomFourierFeatureTrajectorySampler,
)
from .sparse import (
    SGPRCache,
    SGPRParams,
    SparseGaussianProcessRegression,
    SparseVariational,
    SVGPParams,
    fit_svgp_minibatch,
)
from .training import fit_gpr
from .vgp import VariationalGaussianProcess, VGPParams, build_vgp_classifier

# the JAX package's names, then the port's own
__all__ = [
    "GaussianProcessRegressionMCMC",
    "build_gpr_mcmc",
    "MultifidelityAutoregressive",
    "MultifidelityNonlinearAutoregressive",
    "build_multifidelity_autoregressive_models",
    "VariationalGaussianProcess",
    "VGPParams",
    "build_vgp_classifier",
    "BernoulliLikelihood",
    "GaussianLikelihood",
    "PoissonLikelihood",
    "build_sgpr",
    "build_svgp",
    "SGPRParams",
    "SVGPParams",
    "fit_svgp_minibatch",
    "SparseGaussianProcessRegression",
    "SparseVariational",
    "InducingPointSelector",
    "KMeansInducingPointSelector",
    "UniformInducingPointSelector",
    "RandomSubSampleInducingPointSelector",
    "ConditionalVarianceReduction",
    "ConditionalImprovementReduction",
    "DPPInducingPointSelector",
    "build_gpr",
    "default_gpr_params",
    "GPPriors",
    "default_priors",
    "log_prior_density",
    "GaussianProcessRegression",
    "GPRCache",
    "GPRParams",
    "BatchReparametrizationSampler",
    "DecoupledTrajectorySampler",
    "IndependentReparametrizationSampler",
    "RandomFourierFeatureTrajectorySampler",
    "fit_gpr",
    "MAX_NUM_INDUCING_POINTS",
    "NUM_INDUCING_POINTS_PER_DIM",
    "ModelBasedImprovementQualityFunction",
    "UnitQualityFunction",
    "greedy_inference_dpp",
    "SGPRCache",
]
