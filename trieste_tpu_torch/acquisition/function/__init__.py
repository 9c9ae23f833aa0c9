"""Acquisition-function builders and their function forms."""
from .active_learning import (
    BayesianActiveLearningByDisagreement,
    ExpectedFeasibility,
    IntegratedVarianceReduction,
    PredictiveVariance,
)
from .continuous_thompson_sampling import (
    GreedyContinuousThompsonSampling,
    ParallelContinuousThompsonSampling,
    negate_trajectory_function,
)
from .entropy import GIBBON, MinValueEntropySearch
from .function import (
    AugmentedExpectedImprovement,
    BatchExpectedImprovement,
    BatchMonteCarloExpectedImprovement,
    ExpectedConstrainedImprovement,
    ExpectedImprovement,
    FastConstraintsFeasibility,
    MakePositive,
    MonteCarloAugmentedExpectedImprovement,
    MonteCarloExpectedImprovement,
    MultipleOptimismNegativeLowerConfidenceBound,
    NegativeLowerConfidenceBound,
    NegativePredictiveMean,
    ProbabilityOfFeasibility,
    ProbabilityOfImprovement,
    fast_constraints_feasibility,
)
from .functional import (
    PenalizedAcquisition,
    augmented_expected_improvement,
    batch_ehvi,
    batch_expected_improvement,
    batch_monte_carlo_expected_improvement,
    bayesian_active_learning_by_disagreement,
    bichon_ranjan_criterion,
    expected_hv_improvement,
    expected_improvement,
    gibbon_quality_term,
    gibbon_repulsion_term,
    hard_local_penalizer,
    hippo_penalizer,
    integrated_variance_reduction,
    local_penalizer,
    lower_confidence_bound,
    min_value_entropy_search,
    monte_carlo_augmented_expected_improvement,
    monte_carlo_expected_improvement,
    multiple_optimism_lower_confidence_bound,
    predictive_variance,
    probability_below_threshold,
    soft_local_penalizer,
)
from .greedy_batch import Fantasizer, LocalPenalization
from .multi_objective import (
    HIPPO,
    BatchMonteCarloExpectedHypervolumeImprovement,
    ExpectedConstrainedHypervolumeImprovement,
    ExpectedHypervolumeImprovement,
)
from .utils import MultivariateNormalCDF, make_mvn_cdf, mvn_cdf
