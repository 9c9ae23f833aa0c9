"""Observer factories (counterpart of :mod:`trieste_tpu.objectives.utils`)."""
from __future__ import annotations

from typing import Callable

import torch

from ..data import Dataset
from ..observer import SingleObserver


def mk_observer(objective: Callable[[torch.Tensor], torch.Tensor]) -> SingleObserver:
    """Wrap a function ``[N, D] -> [N, L]`` as an observer."""
    return lambda qp: Dataset.from_arrays(qp, objective(qp))
