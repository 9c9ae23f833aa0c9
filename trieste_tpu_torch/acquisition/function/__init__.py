"""Acquisition-function builders."""
from .continuous_thompson_sampling import (
    GreedyContinuousThompsonSampling,
    ParallelContinuousThompsonSampling,
    negate_trajectory_function,
)
from .function import (
    BatchExpectedImprovement,
    BatchMonteCarloExpectedImprovement,
    ExpectedImprovement,
    MonteCarloAugmentedExpectedImprovement,
    MonteCarloExpectedImprovement,
)
from .utils import MultivariateNormalCDF, make_mvn_cdf, mvn_cdf
