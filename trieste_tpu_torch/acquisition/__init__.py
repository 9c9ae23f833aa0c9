"""Acquisition functions, optimizers and rules (counterpart of :mod:`trieste_tpu.acquisition`)."""
from .function.function import ExpectedImprovement
from .interface import AcquisitionFunction, AcquisitionFunctionBuilder, SingleModelAcquisitionBuilder
from .optimizer import FailedOptimizationError, automatic_optimizer_selector, generate_continuous_optimizer
from .rule import AcquisitionRule, EfficientGlobalOptimization
