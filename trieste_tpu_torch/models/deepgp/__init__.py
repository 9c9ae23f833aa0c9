"""Deep Gaussian processes (counterpart of :mod:`trieste_tpu.models.deepgp`)."""

from .deep_gp import (
    DeepGaussianProcess,
    DGPLayerParams,
    DGPParams,
    build_vanilla_deep_gp,
)

__all__ = [
    "DeepGaussianProcess",
    "DGPLayerParams",
    "DGPParams",
    "build_vanilla_deep_gp",
]
