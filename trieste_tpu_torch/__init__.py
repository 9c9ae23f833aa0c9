"""trieste_tpu_torch: the PyTorch/CUDA port of trieste_tpu.

The first slice covers the README quickstart path: ``Box`` and the padded ``Dataset``,
exact GPR with a multi-start MAP fit, analytic expected improvement, the continuous
acquisition optimizer, ``EfficientGlobalOptimization`` and the ``BayesianOptimizer`` loop,
with the fused prediction kernel in CUDA for Hopper. Entry points work on ``cuda`` unless
the caller puts its tensors (or its ``Box``) on the CPU.
"""
from .bayesian_optimizer import BayesianOptimizer, OptimizationResult, Record
from .data import Dataset
from .space import Box, SearchSpace
