"""trieste_tpu_torch: the PyTorch/CUDA port of trieste_tpu.

It covers the search spaces (``Box``, discrete, categorical, tagged product and multi
spaces) and the padded ``Dataset``, exact GPR with a multi-start MAP fit and its posterior
samplers, the acquisition families (expected improvement, analytic, Monte-Carlo and
batch; confidence bounds; entropy search; active learning; greedy batches), Thompson
sampling (discrete and continuous), the continuous, relaxed and discrete acquisition
optimizers, the point-selection rules (``EfficientGlobalOptimization``,
``DiscreteThompsonSampling``, the asynchronous rules, the trust-region fleets), and the two
loops, ``BayesianOptimizer`` and ``AskTellOptimizer`` with their summaries
(:mod:`~trieste_tpu_torch.logging`), the deep models (:mod:`~trieste_tpu_torch.models.ensembles`,
:mod:`~trieste_tpu_torch.models.deepgp`) and the experimental plotting, with the fused
prediction kernel in CUDA for Hopper. Entry points work on ``cuda`` unless the caller puts its tensors (or its
space) on the CPU. :mod:`~trieste_tpu_torch.parallel` shards the pool-shaped stages over
the ranks of a ``torch.distributed`` group.
"""
from . import acquisition, logging, models, objectives, profiling, space, utils
from .ask_tell_optimization import (
    AskTellOptimizer,
    AskTellOptimizerABC,
    AskTellOptimizerNoTraining,
    AskTellOptimizerState,
)
from .bayesian_optimizer import (
    BayesianOptimizer,
    FrozenRecord,
    OptimizationResult,
    Record,
    stop_at_minimum,
)
from .data import Dataset
from .observer import OBJECTIVE, Observer
from .space import (
    Box,
    CategoricalSearchSpace,
    DiscreteSearchSpace,
    GeneralDiscreteSearchSpace,
    SearchSpace,
    TaggedMultiSearchSpace,
    TaggedProductSearchSpace,
)
from .version import VERSION

__version__ = VERSION

# the JAX package's names, and the search spaces, which the port also exports here
__all__ = [
    "AskTellOptimizer",
    "AskTellOptimizerABC",
    "AskTellOptimizerNoTraining",
    "AskTellOptimizerState",
    "BayesianOptimizer",
    "Box",
    "CategoricalSearchSpace",
    "Dataset",
    "DiscreteSearchSpace",
    "FrozenRecord",
    "GeneralDiscreteSearchSpace",
    "OBJECTIVE",
    "Observer",
    "OptimizationResult",
    "Record",
    "SearchSpace",
    "TaggedMultiSearchSpace",
    "TaggedProductSearchSpace",
    "acquisition",
    "logging",
    "models",
    "objectives",
    "space",
    "stop_at_minimum",
    "utils",
]
