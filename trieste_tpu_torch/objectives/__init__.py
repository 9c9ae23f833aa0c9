"""Benchmark objectives and observer factories (counterpart of :mod:`trieste_tpu.objectives`)."""
from .multi_objectives import (
    DTLZ1,
    DTLZ2,
    VLMOP2,
    MultiObjectiveTestProblem,
    dtlz1,
    dtlz2,
    vlmop2,
)
from .single_objectives import (
    Branin,
    ConstrainedScaledBranin,
    Hartmann6,
    ObjectiveTestProblem,
    ScaledBranin,
    SimpleQuadratic,
    SingleObjectiveTestProblem,
    branin,
    hartmann_6,
    scaled_branin,
    simple_quadratic,
)
from .utils import mk_batch_observer, mk_multi_observer, mk_observer
from .multifidelity_objectives import (
    Linear2Fidelity,
    Linear3Fidelity,
    Linear5Fidelity,
    SingleObjectiveMultifidelityTestProblem,
    linear_multifidelity,
)
