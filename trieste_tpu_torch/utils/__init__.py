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
    get_value_for_tag,
    ignoring_local_tags,
    jitter_for,
    map_values,
)
