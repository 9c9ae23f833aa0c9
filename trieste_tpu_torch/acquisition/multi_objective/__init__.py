"""Multi-objective utilities (counterpart of :mod:`trieste_tpu.acquisition.multi_objective`)."""
from .dominance import non_dominated, non_dominated_mask
from .pareto import Pareto, get_reference_point
from .partition import (
    DividedAndConquerNonDominated,
    ExactPartition2dNonDominated,
    non_dominated_partition_bounds,
    prepare_default_non_dominated_partition_bounds,
)

__all__ = [
    "DividedAndConquerNonDominated",
    "ExactPartition2dNonDominated",
    "Pareto",
    "get_reference_point",
    "non_dominated",
    "non_dominated_mask",
    "non_dominated_partition_bounds",
    "prepare_default_non_dominated_partition_bounds",
]
