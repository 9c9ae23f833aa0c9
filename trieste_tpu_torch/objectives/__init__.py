"""Benchmark objectives and observer factories (counterpart of :mod:`trieste_tpu.objectives`)."""
from .single_objectives import (
    Branin,
    Hartmann6,
    ObjectiveTestProblem,
    ScaledBranin,
    SingleObjectiveTestProblem,
    branin,
    hartmann_6,
    scaled_branin,
)
from .utils import mk_batch_observer, mk_observer
