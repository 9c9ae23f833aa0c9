"""Acquisition functions, optimizers and rules (counterpart of :mod:`trieste_tpu.acquisition`)."""
from .function import (
    BatchExpectedImprovement,
    BatchMonteCarloExpectedImprovement,
    ExpectedImprovement,
    GreedyContinuousThompsonSampling,
    MonteCarloAugmentedExpectedImprovement,
    MonteCarloExpectedImprovement,
    ParallelContinuousThompsonSampling,
)
from .interface import (
    AcquisitionFunction,
    AcquisitionFunctionBuilder,
    GreedyAcquisitionFunctionBuilder,
    SingleModelAcquisitionBuilder,
    SingleModelGreedyAcquisitionBuilder,
    SingleModelVectorizedAcquisitionBuilder,
    VectorizedAcquisitionFunctionBuilder,
)
from .optimizer import (
    FailedOptimizationError,
    automatic_optimizer_selector,
    batchify_joint,
    batchify_vectorize,
    generate_continuous_optimizer,
    generate_random_search_optimizer,
)
from .rule import (
    AcquisitionRule,
    AsynchronousGreedy,
    AsynchronousOptimization,
    AsynchronousRuleState,
    DiscreteThompsonSampling,
    EfficientGlobalOptimization,
    RandomSampling,
)
from .sampler import (
    ExactThompsonSampler,
    GumbelSampler,
    ThompsonSampler,
    ThompsonSamplerFromTrajectory,
)
