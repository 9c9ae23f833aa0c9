"""trieste_tpu_torch: the PyTorch/CUDA port of trieste_tpu.

It covers the search spaces (``Box``, discrete, categorical, tagged product and multi
spaces) and the padded ``Dataset``, exact GPR with a multi-start MAP fit and its posterior
samplers, the acquisition families (expected improvement, analytic, Monte-Carlo and
batch; confidence bounds; entropy search; active learning; greedy batches), Thompson
sampling (discrete and continuous), the continuous, relaxed and discrete acquisition
optimizers, the point-selection rules (``EfficientGlobalOptimization``,
``DiscreteThompsonSampling``, the asynchronous rules, the trust-region fleets), and the two
loops, ``BayesianOptimizer`` and ``AskTellOptimizer``, with the fused prediction kernel in
CUDA for Hopper. Entry points work on ``cuda`` unless the caller puts its tensors (or its
space) on the CPU.
"""
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
