"""Utilities (counterpart of :mod:`trieste_tpu.utils`)."""
from .misc import (
    DEFAULTS,
    Err,
    LocalizedTag,
    Ok,
    Result,
    Timer,
    default_float,
    flatten_leading_dims,
    jitter_for,
)
