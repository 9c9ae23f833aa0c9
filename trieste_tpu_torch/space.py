"""Search spaces (counterpart of :mod:`trieste_tpu.space`): the :class:`SearchSpace` ABC
and an unconstrained :class:`Box` with uniform, Halton and Sobol sampling. Constraints,
discrete and tagged product spaces are not ported yet.

>>> box = Box([0.0, 0.0], [1.0, 2.0], device="cpu")
>>> box.dimension, tuple(box.sample(torch.Generator().manual_seed(0), 5).shape)
(2, (5, 2))
>>> bool(box.contains(torch.tensor([0.5, 1.5])))
True
"""
from __future__ import annotations

import operator
from abc import ABC, abstractmethod
from functools import reduce
from typing import Optional, Union

import numpy as np
import torch

from .types import TensorType
from .utils.misc import default_float


class SearchSpace(ABC):
    """A space of valid query points."""

    @abstractmethod
    def sample(self, generator: Optional[torch.Generator], num_samples: int) -> torch.Tensor:
        """Sample ``num_samples`` points uniformly at random, shape ``[n, D]``."""

    @property
    @abstractmethod
    def dimension(self) -> int:
        """Number of input dimensions."""

    @property
    @abstractmethod
    def device(self) -> torch.device:
        """The device that samples and bounds live on."""

    @property
    @abstractmethod
    def lower(self) -> torch.Tensor:
        """Lower bounds, shape ``[D]``."""

    @property
    @abstractmethod
    def upper(self) -> torch.Tensor:
        """Upper bounds, shape ``[D]``."""

    @abstractmethod
    def _contains(self, value: torch.Tensor) -> torch.Tensor:
        ...

    def contains(self, value: torch.Tensor) -> torch.Tensor:
        """Membership test; supports leading batch dims."""
        if value.shape[-1] != self.dimension:
            raise ValueError(f"value has dimension {value.shape[-1]}, space has {self.dimension}")
        return self._contains(value)

    def __contains__(self, value: torch.Tensor) -> bool:
        return bool(self.contains(value))

    def product(self, *others: "SearchSpace") -> "SearchSpace":
        """Cartesian product."""
        return reduce(operator.mul, others, self)

    @abstractmethod
    def __mul__(self, other: "SearchSpace") -> "SearchSpace":
        ...

    def __pow__(self, other: int) -> "SearchSpace":
        if other < 1:
            raise ValueError(f"power must be >= 1, got {other}")
        return self.product(*[self] * (other - 1))


class Box(SearchSpace):
    """A continuous box ``[lower, upper]`` on one device.

    The bounds are kept on the host (numpy) and become tensors on ``device`` when read,
    so a box can be built where no card is present. Zero-width dimensions are valid.
    """

    def __init__(
        self,
        lower: TensorType,
        upper: TensorType,
        *,
        dtype: Optional[torch.dtype] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        if isinstance(lower, torch.Tensor):
            lower = lower.detach().cpu().numpy()
        if isinstance(upper, torch.Tensor):
            upper = upper.detach().cpu().numpy()
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        if lower.ndim != 1 or upper.ndim != 1:
            raise ValueError("bounds must be rank 1")
        if lower.shape != upper.shape:
            raise ValueError(f"bound shapes differ: {lower.shape} vs {upper.shape}")
        if not bool(np.all(lower <= upper)):
            raise ValueError("lower must not exceed upper")
        self._lower = lower
        self._upper = upper
        self._dtype = dtype or default_float()
        self._device = torch.device(device)

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def device(self) -> torch.device:
        return self._device

    def to(
        self,
        device: Optional[Union[str, torch.device]] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> "Box":
        """The same box on another device or with another dtype."""
        return Box(
            self._lower, self._upper, dtype=dtype or self._dtype, device=device or self._device
        )

    @property
    def lower(self) -> torch.Tensor:
        return torch.as_tensor(self._lower, dtype=self._dtype, device=self._device)

    @property
    def upper(self) -> torch.Tensor:
        return torch.as_tensor(self._upper, dtype=self._dtype, device=self._device)

    @property
    def dimension(self) -> int:
        return self._lower.shape[0]

    def _contains(self, value: torch.Tensor) -> torch.Tensor:
        lo, hi = self.lower.to(value.device), self.upper.to(value.device)
        return torch.all((value >= lo) & (value <= hi), dim=-1)

    def sample(self, generator: Optional[torch.Generator], num_samples: int) -> torch.Tensor:
        """Uniform sampling; ``generator`` must live on the box's device."""
        u = torch.rand(
            (num_samples, self.dimension), generator=generator, dtype=self._dtype,
            device=self._device,
        )
        return self._scale(u)

    def _scale(self, u: torch.Tensor) -> torch.Tensor:
        return self.lower + u * (self.upper - self.lower)

    def sample_halton(
        self, generator: Optional[torch.Generator], num_samples: int
    ) -> torch.Tensor:
        """Halton sampling on the box's device, randomized by a rotation drawn from
        ``generator`` (``None``: the deterministic sequence)."""
        from .ops.qmc import halton_sample

        return self._scale(
            halton_sample(generator, num_samples, self.dimension, self._dtype, self._device)
        )

    def sample_sobol(self, num_samples: int, skip: Optional[int] = None) -> torch.Tensor:
        """Sobol sampling: generated on the host, then placed on the box's device."""
        from .ops.qmc import sobol_sample

        return self._scale(
            sobol_sample(num_samples, self.dimension, skip, self._dtype, self._device)
        )

    def __mul__(self, other: SearchSpace) -> SearchSpace:
        if not isinstance(other, Box):
            raise NotImplementedError("only products of boxes are ported")
        return Box(
            np.concatenate([self._lower, other._lower]),
            np.concatenate([self._upper, other._upper]),
            dtype=self._dtype,
            device=self._device,
        )

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Box)
            and bool(np.array_equal(self._lower, other._lower))
            and bool(np.array_equal(self._upper, other._upper))
        )

    def __repr__(self) -> str:
        return f"Box({self._lower!r}, {self._upper!r}, device={str(self._device)!r})"
