"""Quasi-Monte-Carlo sequences (counterpart of :mod:`trieste_tpu.ops.qmc`).

Halton points are generated on the device with a Cranley-Patterson rotation drawn from
an explicit generator; Sobol points come from scipy's direction numbers on the host (they
are used when a function is prepared, never inside an optimizer's loop).

>>> halton_sample(None, 3, 2, dtype=torch.float64, device="cpu")[:, 0].tolist()
[0.5, 0.25, 0.75]
"""
from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from ..utils.misc import check_generator, default_float

Device = Union[str, torch.device]


def _primes(n: int) -> list:
    found: list = []
    candidate = 2
    while len(found) < n:
        if all(candidate % p for p in found):
            found.append(candidate)
        candidate += 1
    return found


_PRIMES = _primes(168)  # Halton supports up to 168 dimensions


def _radical_inverse(indices: torch.Tensor, base: int, num_digits: int, dtype) -> torch.Tensor:
    """Van der Corput radical inverse of integer ``indices`` in ``base``."""
    result = torch.zeros(indices.shape, dtype=dtype, device=indices.device)
    inv_base = torch.tensor(1.0 / base, dtype=dtype, device=indices.device)
    factor = inv_base
    idx = indices
    for _ in range(num_digits):
        result = result + (idx % base).to(dtype) * factor
        idx = idx // base
        factor = factor * inv_base
    return result


def halton_sample(
    generator: Optional[torch.Generator],
    num_samples: int,
    dimension: int,
    dtype: Optional[torch.dtype] = None,
    device: Device = "cuda",
) -> torch.Tensor:
    """Halton points in ``[0, 1)^D``, shape ``[num_samples, D]``, randomized by the
    rotation ``(halton + u) mod 1`` with ``u ~ U[0,1)^D`` drawn from ``generator``;
    ``generator=None`` gives the deterministic sequence."""
    if dimension > len(_PRIMES):
        raise ValueError(f"Halton supports up to {len(_PRIMES)} dims, got {dimension}")
    dtype = dtype or default_float()
    if dimension == 0:
        return torch.zeros((num_samples, 0), dtype=dtype, device=device)
    indices = torch.arange(1, num_samples + 1, dtype=torch.int64, device=device)
    cols = []
    for base in _PRIMES[:dimension]:
        num_digits = max(1, math.ceil(math.log(num_samples + 1) / math.log(base)))
        cols.append(_radical_inverse(indices, base, num_digits, dtype))
    pts = torch.stack(cols, dim=-1)
    if generator is not None:
        check_generator(generator, device)
        shift = torch.rand((dimension,), generator=generator, dtype=dtype, device=device)
        pts = torch.remainder(pts + shift, 1.0)
    return pts


def sobol_sample(
    num_samples: int,
    dimension: int,
    skip: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    device: Device = "cuda",
) -> torch.Tensor:
    """Unscrambled Sobol points in ``[0, 1)^D``, shape ``[num_samples, D]``, generated on
    the host and placed on ``device``."""
    from scipy.stats import qmc

    engine = qmc.Sobol(d=dimension, scramble=False)
    if skip:
        engine.fast_forward(skip)
    pts = np.asarray(engine.random(num_samples))
    return torch.as_tensor(pts, dtype=dtype or default_float(), device=device)


def qmc_normal_samples(
    num_samples: int,
    shape_tail: int,
    skip: int = 0,
    dtype: Optional[torch.dtype] = None,
    device: Device = "cuda",
) -> torch.Tensor:
    """Quasi-random standard-normal samples by Sobol points and the inverse CDF, shape
    ``[num_samples, shape_tail]``."""
    dtype = dtype or default_float()
    # the first Sobol point is all zeros, -inf under the inverse CDF: skip it
    u = sobol_sample(num_samples, shape_tail, skip=skip + 1, dtype=dtype, device=device)
    info = torch.finfo(dtype)
    return torch.special.ndtri(torch.clamp(u, info.tiny, 1.0 - info.eps / 2))
