"""Observational data containers (counterpart of :mod:`trieste_tpu.data`).

A :class:`Dataset` is a **fixed-capacity padded buffer** plus a count of valid leading
rows, as in the JAX package: capacity is a power of two and grows geometrically, so the
GP numerics see O(log n) distinct shapes over a BO run, and everything downstream is
mask-aware (rows at or beyond ``num_points`` are padding and never influence results).

>>> ds = Dataset.from_arrays(torch.zeros(3, 2), torch.ones(3, 1))
>>> len(ds), ds.capacity
(3, 8)
>>> combined = ds + Dataset.from_arrays(torch.ones(2, 2), torch.zeros(2, 1))
>>> len(combined), bool(combined.mask[4]), bool(combined.mask[5])
(5, True, False)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


def _ceil_pow2(n: int, minimum: int = 8) -> int:
    c = minimum
    while c < n:
        c *= 2
    return c


@dataclass(frozen=True)
class Dataset:
    """Query points and observations in padded buffers.

    :param query_points: padded ``[C, D]`` buffer of query points.
    :param observations: padded ``[C, L]`` buffer of observations.
    :param num_points: count of valid leading rows (``<= C``).
    """

    query_points: torch.Tensor
    observations: torch.Tensor
    num_points: int

    def __post_init__(self) -> None:
        qp, obs = self.query_points, self.observations
        if qp.ndim != 2 or obs.ndim != 2:
            raise ValueError(
                f"query_points and observations must be rank 2, got "
                f"{tuple(qp.shape)} and {tuple(obs.shape)}"
            )
        if qp.shape[0] != obs.shape[0]:
            raise ValueError(
                f"Leading shapes must match, got {tuple(qp.shape)} and {tuple(obs.shape)}"
            )
        if qp.device != obs.device:
            raise ValueError(f"query_points on {qp.device}, observations on {obs.device}")
        if not 0 <= self.num_points <= qp.shape[0]:
            raise ValueError(f"num_points {self.num_points} outside [0, {qp.shape[0]}]")

    @classmethod
    def from_arrays(
        cls,
        query_points: torch.Tensor,
        observations: torch.Tensor,
        capacity: Optional[int] = None,
    ) -> "Dataset":
        """Build a dataset from exact-size tensors, padding up to ``capacity`` (default:
        the next power of two, at least 8)."""
        if not isinstance(query_points, torch.Tensor) or not isinstance(
            observations, torch.Tensor
        ):
            raise TypeError("query_points and observations must be torch tensors")
        qp, obs = query_points, observations
        if qp.ndim != 2 or obs.ndim != 2 or qp.shape[0] != obs.shape[0]:
            raise ValueError(
                f"expected matching rank-2 tensors, got {tuple(qp.shape)} and {tuple(obs.shape)}"
            )
        n = qp.shape[0]
        cap = _ceil_pow2(n) if capacity is None else capacity
        if cap < n:
            raise ValueError(f"capacity {cap} < number of points {n}")
        qp = torch.cat([qp, qp.new_zeros(cap - n, qp.shape[1])])
        obs = torch.cat([obs, obs.new_zeros(cap - n, obs.shape[1])])
        return cls(qp, obs, n)

    @property
    def capacity(self) -> int:
        return self.query_points.shape[0]

    @property
    def dimension(self) -> int:
        return self.query_points.shape[-1]

    @property
    def num_outputs(self) -> int:
        return self.observations.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.query_points.device

    @property
    def mask(self) -> torch.Tensor:
        """``[C]`` boolean validity mask."""
        return torch.arange(self.capacity, device=self.device) < self.num_points

    def __len__(self) -> int:
        return self.num_points

    @property
    def trimmed_query_points(self) -> torch.Tensor:
        return self.query_points[: self.num_points]

    @property
    def trimmed_observations(self) -> torch.Tensor:
        return self.observations[: self.num_points]

    def astuple(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The trimmed ``(query_points, observations)`` pair."""
        return self.trimmed_query_points, self.trimmed_observations

    def with_capacity(self, capacity: int) -> "Dataset":
        """A copy padded (or validly trimmed) to exactly ``capacity``."""
        if capacity == self.capacity:
            return self
        if capacity < self.num_points:
            raise ValueError(f"cannot trim capacity {capacity} below count {self.num_points}")
        if capacity < self.capacity:
            return Dataset(
                self.query_points[:capacity], self.observations[:capacity], self.num_points
            )
        extra = capacity - self.capacity
        return Dataset(
            torch.cat([self.query_points, self.query_points.new_zeros(extra, self.dimension)]),
            torch.cat([self.observations, self.observations.new_zeros(extra, self.num_outputs)]),
            self.num_points,
        )

    def append_within_capacity(
        self, query_points: torch.Tensor, observations: torch.Tensor
    ) -> "Dataset":
        """Write ``[B, D]``/``[B, L]`` rows at ``num_points``; they must fit the capacity."""
        start, stop = self.num_points, self.num_points + query_points.shape[0]
        if stop > self.capacity:
            raise ValueError(f"{stop} points exceed the capacity {self.capacity}")
        qp = self.query_points.clone()
        obs = self.observations.clone()
        qp[start:stop] = query_points.to(qp.dtype)
        obs[start:stop] = observations.to(obs.dtype)
        return Dataset(qp, obs, stop)

    def __add__(self, other: "Dataset") -> "Dataset":
        """Concatenation, growing the capacity geometrically when needed."""
        n_total = self.num_points + other.num_points
        ds = self
        if n_total > self.capacity:
            ds = self.with_capacity(_ceil_pow2(n_total, minimum=self.capacity * 2))
        return ds.append_within_capacity(*other.astuple())

    def __repr__(self) -> str:
        return (
            f"Dataset(n={self.num_points}/{self.capacity}, D={self.dimension}, "
            f"L={self.num_outputs})"
        )


# -- multifidelity helpers: query points carry a trailing fidelity column --------------


def check_and_extract_fidelity_query_points(
    query_points: torch.Tensor, max_fidelity: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``[..., D+1]`` points into the inputs ``[..., D]`` and the fidelity column
    ``[..., 1]``, after checking that the fidelities are non-negative integers no larger
    than ``max_fidelity`` (one reduction and one read from the device)."""
    if query_points.shape[-1] < 2:
        raise ValueError(
            "Query points do not have enough dimensions to include a fidelity column"
        )
    input_points, fids = query_points[..., :-1], query_points[..., -1:]
    if fids.numel():
        checks = [(fids < 0).any(), (fids != torch.round(fids)).any()]
        if max_fidelity is not None:
            checks.append((fids > max_fidelity).any())
        flags = torch.stack(checks).tolist()
        if flags[0]:
            raise ValueError(f"fidelity must be non-negative, got minimum {float(fids.min())}")
        if flags[1]:
            raise ValueError("fidelity column must contain integer values")
        if max_fidelity is not None and flags[2]:
            raise ValueError(
                f"fidelity {float(fids.max())} exceeds the maximum fidelity {max_fidelity}"
            )
    return input_points, fids


def split_dataset_by_fidelity(dataset: Dataset, num_fidelities: int) -> list[Dataset]:
    """One dataset per fidelity level, without the fidelity column."""
    if num_fidelities < 1:
        raise ValueError(f"num_fidelities must be positive, got {num_fidelities}")
    return [get_dataset_for_fidelity(dataset, f) for f in range(num_fidelities)]


def get_dataset_for_fidelity(dataset: Dataset, fidelity: int) -> Dataset:
    """The points at one fidelity, without the fidelity column."""
    inputs, fids = check_and_extract_fidelity_query_points(dataset.trimmed_query_points)
    at = fids[:, 0] == fidelity
    return Dataset.from_arrays(inputs[at], dataset.trimmed_observations[at])


def add_fidelity_column(query_points: torch.Tensor, fidelity) -> torch.Tensor:
    """``query_points`` with a fidelity column appended."""
    col = torch.as_tensor(fidelity, dtype=query_points.dtype, device=query_points.device)
    return torch.cat([query_points, col.expand(query_points.shape[:-1] + (1,))], dim=-1)
