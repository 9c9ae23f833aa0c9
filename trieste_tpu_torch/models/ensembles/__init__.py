"""Deep-ensemble models (counterpart of :mod:`trieste_tpu.models.ensembles`)."""

from .deep_ensemble import (
    DeepEnsemble,
    DeepEnsembleParams,
    DeepEnsembleTrajectorySampler,
    GaussianMLP,
    build_deep_ensemble,
)

build_keras_ensemble = build_deep_ensemble
"""The reference's name for the builder."""

__all__ = [
    "DeepEnsemble",
    "DeepEnsembleParams",
    "DeepEnsembleTrajectorySampler",
    "GaussianMLP",
    "build_deep_ensemble",
    "build_keras_ensemble",
]
