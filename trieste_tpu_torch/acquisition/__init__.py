"""Acquisition functions, optimizers and rules (counterpart of :mod:`trieste_tpu.acquisition`)."""
from .combination import Map, Product, Reducer, Sum
from .function import (
    GIBBON,
    AugmentedExpectedImprovement,
    BatchExpectedImprovement,
    BatchMonteCarloExpectedImprovement,
    BayesianActiveLearningByDisagreement,
    ExpectedConstrainedImprovement,
    ExpectedFeasibility,
    ExpectedImprovement,
    Fantasizer,
    GreedyContinuousThompsonSampling,
    IntegratedVarianceReduction,
    LocalPenalization,
    MakePositive,
    MinValueEntropySearch,
    MonteCarloAugmentedExpectedImprovement,
    MonteCarloExpectedImprovement,
    MultipleOptimismNegativeLowerConfidenceBound,
    NegativeLowerConfidenceBound,
    NegativePredictiveMean,
    ParallelContinuousThompsonSampling,
    PredictiveVariance,
    ProbabilityOfFeasibility,
    ProbabilityOfImprovement,
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
