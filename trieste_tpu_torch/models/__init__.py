"""Probabilistic models (counterpart of :mod:`trieste_tpu.models`)."""
from .interfaces import ProbabilisticModel, TrainableProbabilisticModel
