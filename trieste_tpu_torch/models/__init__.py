"""Probabilistic models (counterpart of :mod:`trieste_tpu.models`)."""
from .interfaces import (
    FastUpdateModel,
    HasReparamSampler,
    HasReparamSamplerModelStack,
    HasTrajectorySampler,
    ModelStack,
    PredictJointModelStack,
    PredictYModelStack,
    ProbabilisticModel,
    ReparametrizationSampler,
    SupportsCovarianceBetweenPoints,
    SupportsCovarianceWithTopFidelity,
    SupportsGetInducingVariables,
    SupportsGetInternalData,
    SupportsGetKernel,
    SupportsGetMeanFunction,
    SupportsGetObservationNoise,
    SupportsPredictJoint,
    SupportsPredictY,
    TrainableModelStack,
    TrainablePredictJointModelStack,
    TrainableProbabilisticModel,
    TrajectoryFunction,
    TrajectoryFunctionClass,
    TrajectorySampler,
)
from .stacks import StackReparametrizationSampler

from . import ensembles, gp  # noqa: E402 - after the protocols they import
