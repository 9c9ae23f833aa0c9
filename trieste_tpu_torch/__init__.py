"""trieste_tpu_torch: the PyTorch/CUDA port of trieste_tpu.

It covers ``Box`` and the padded ``Dataset``, exact GPR with a multi-start MAP fit and its
posterior samplers, the expected-improvement family (analytic, Monte-Carlo, batch),
Thompson sampling (discrete and continuous), the continuous acquisition optimizer, the
point-selection rules (``EfficientGlobalOptimization``, ``DiscreteThompsonSampling``, the
asynchronous rules), and the two loops, ``BayesianOptimizer`` and ``AskTellOptimizer``,
with the fused prediction kernel in CUDA for Hopper. Entry points work on ``cuda`` unless
the caller puts its tensors (or its ``Box``) on the CPU.
"""
from .ask_tell_optimization import (
    AskTellOptimizer,
    AskTellOptimizerNoTraining,
    AskTellOptimizerState,
)
from .bayesian_optimizer import BayesianOptimizer, FrozenRecord, OptimizationResult, Record
from .data import Dataset
from .space import Box, SearchSpace
