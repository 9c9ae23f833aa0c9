"""Acquisition utilities (the ``predictor`` part of :mod:`trieste_tpu.acquisition.utils`)."""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def predictor(model) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """The marginal-prediction callable of ``model``, bound to its current state."""
    return model.predict
