"""Search spaces (counterpart of :mod:`trieste_tpu.space`): the :class:`SearchSpace` ABC,
a :class:`Box` with uniform, Halton and Sobol sampling, the discrete and
categorical spaces, and the tagged product and multi spaces (the latter is the acquisition
space of a trust-region fleet), with the one-hot encoders, and the linear and nonlinear
constraints that a box may carry, with rejection sampling of feasible points.

Every space lives on one device: a box becomes tensors there when its bounds are read, a
discrete space keeps its points there, and a collection requires all its subspaces there.

>>> box = Box([0.0, 0.0], [1.0, 2.0], device="cpu")
>>> box.dimension, tuple(box.sample(torch.Generator().manual_seed(0), 5).shape)
(2, (5, 2))
>>> bool(box.contains(torch.tensor([0.5, 1.5])))
True
>>> discrete = DiscreteSearchSpace(torch.tensor([[0.0], [0.5], [1.0]]))
>>> product = box * discrete  # a tagged product: the dimensions are concatenated
>>> product.dimension, product.subspace_tags
(3, ('0', '1'))
>>> disk = NonlinearConstraint(lambda x: torch.sum(torch.square(x - 0.5), -1), 0.0, 0.25)
>>> unit = Box([0.0, 0.0], [1.0, 1.0], constraints=[disk], device="cpu")
>>> bool(unit.is_feasible(unit.sample_feasible(torch.Generator().manual_seed(0), 8)).all())
True
>>> fleet = TaggedMultiSearchSpace([box, Box([0.0, 0.0], [0.5, 0.5], device="cpu")])
>>> tuple(fleet.sample(torch.Generator().manual_seed(0), 4).shape)  # [n, V, D]
(4, 2, 2)
"""
from __future__ import annotations

import operator
from abc import ABC, abstractmethod
from functools import reduce
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .types import TensorType
from .utils.misc import default_float

EncoderFunction = Callable[[torch.Tensor], torch.Tensor]


class HasOneHotEncoder:
    """Marker of spaces that offer a one-hot ``one_hot_encoder``."""

    def one_hot_encoder(self) -> Optional[EncoderFunction]:  # pragma: no cover
        return None


DEFAULT_DTYPE_EPS = 1e-7
"""How far below zero a residual may fall with the point still feasible."""


class SampleTimeoutError(Exception):
    """Raised when rejection sampling of feasible points fails to find enough points."""


def _constraint_tensor(value: TensorType) -> torch.Tensor:
    """A constraint's coefficients as a tensor: a tensor keeps its device, anything else
    becomes an fp64 tensor on the CPU. A box moves its constraints to its own device."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.as_tensor(np.asarray(value, np.float64))


class Constraint(ABC):
    """A constraint on a search space."""

    @abstractmethod
    def residual(self, points: torch.Tensor) -> torch.Tensor:
        """Residuals, all ``>= 0`` iff feasible, shape ``[..., num_residuals]``."""

    @abstractmethod
    def shift(self, offset: int, width: int, total_dim: int) -> "Constraint":
        """The same constraint on dims ``[offset, offset + width)`` of a
        ``total_dim``-dimensional product space."""

    @abstractmethod
    def to(self, device: Union[str, torch.device], dtype: torch.dtype) -> "Constraint":
        """The same constraint with its coefficients on ``device`` in ``dtype``."""


class LinearConstraint(Constraint):
    """The linear constraint ``lb <= A @ x <= ub``."""

    def __init__(self, A: TensorType, lb: TensorType, ub: TensorType):
        self.A = _constraint_tensor(A)
        rows = (self.A.shape[0],)
        self.lb = _constraint_tensor(lb).to(self.A).expand(rows)
        self.ub = _constraint_tensor(ub).to(self.A).expand(rows)

    def residual(self, points: torch.Tensor) -> torch.Tensor:
        ax = points @ self.A.to(points).T
        return torch.cat([ax - self.lb.to(points), self.ub.to(points) - ax], dim=-1)

    def shift(self, offset: int, width: int, total_dim: int) -> "LinearConstraint":
        A = self.A.new_zeros((self.A.shape[0], total_dim))
        A[:, offset : offset + width] = self.A
        return LinearConstraint(A, self.lb, self.ub)

    def to(self, device: Union[str, torch.device], dtype: torch.dtype) -> "LinearConstraint":
        move = lambda t: t.to(device=device, dtype=dtype)  # noqa: E731
        return LinearConstraint(move(self.A), move(self.lb), move(self.ub))

    def __repr__(self) -> str:
        return f"LinearConstraint(A={self.A!r}, lb={self.lb!r}, ub={self.ub!r})"

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, LinearConstraint)
            and torch.equal(self.A, other.A.to(self.A))
            and torch.equal(self.lb, other.lb.to(self.lb))
            and torch.equal(self.ub, other.ub.to(self.ub))
        )


class NonlinearConstraint(Constraint):
    """The constraint ``lb <= f(x) <= ub`` for a differentiable torch function ``f`` of
    ``[..., D]`` points (one value per point, or ``[..., k]`` values)."""

    def __init__(self, f: Callable[[torch.Tensor], torch.Tensor], lb: TensorType, ub: TensorType):
        self.f = f
        self.lb = torch.atleast_1d(_constraint_tensor(lb))
        self.ub = torch.atleast_1d(_constraint_tensor(ub).to(self.lb))

    def residual(self, points: torch.Tensor) -> torch.Tensor:
        val = self.f(points)
        if val.ndim == points.ndim - 1:
            val = val[..., None]
        return torch.cat([val - self.lb.to(val), self.ub.to(val) - val], dim=-1)

    def shift(self, offset: int, width: int, total_dim: int) -> "NonlinearConstraint":
        inner, lo, hi = self.f, offset, offset + width
        return NonlinearConstraint(lambda points: inner(points[..., lo:hi]), self.lb, self.ub)

    def to(self, device: Union[str, torch.device], dtype: torch.dtype) -> "NonlinearConstraint":
        move = lambda t: t.to(device=device, dtype=dtype)  # noqa: E731
        return NonlinearConstraint(self.f, move(self.lb), move(self.ub))

    def __repr__(self) -> str:
        return f"NonlinearConstraint(f={self.f!r}, lb={self.lb!r}, ub={self.ub!r})"


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

    @property
    def constraints(self) -> Sequence[Constraint]:
        """The constraints on this space (default: none)."""
        return []

    @property
    def has_constraints(self) -> bool:
        return len(self.constraints) > 0

    def constraints_residuals(self, points: torch.Tensor) -> torch.Tensor:
        """All the constraints' residuals side by side, ``[..., sum of residuals]``."""
        if not self.constraints:
            raise NotImplementedError("space has no constraints")
        return torch.cat([c.residual(points) for c in self.constraints], dim=-1)

    def is_feasible(self, points: torch.Tensor) -> torch.Tensor:
        """Whether each point satisfies every constraint (to ``DEFAULT_DTYPE_EPS``)."""
        return torch.all(self.constraints_residuals(points) >= -DEFAULT_DTYPE_EPS, dim=-1)

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

    def discretize(
        self, generator: Optional[torch.Generator], num_samples: int
    ) -> "DiscreteSearchSpace":
        """A discrete space of ``num_samples`` uniform samples."""
        return DiscreteSearchSpace(self.sample(generator, num_samples))


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name one card: compare the index only where both give one."""
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def _points_tensor(
    points: TensorType, dtype: Optional[torch.dtype], device: Optional[Union[str, torch.device]]
) -> torch.Tensor:
    """A point set as a tensor: a tensor stays on its device unless told otherwise, an
    array goes to ``device`` (default ``cuda``)."""
    if isinstance(points, torch.Tensor):
        points = points.detach()
        return points.to(dtype=dtype or points.dtype, device=device or points.device)
    return torch.as_tensor(np.asarray(points), dtype=dtype or default_float(), device=device or "cuda")


class GeneralDiscreteSearchSpace(SearchSpace):
    """A finite space given by an explicit point set ``[N, D]``, held on one device."""

    def __init__(
        self,
        points: TensorType,
        *,
        dtype: Optional[torch.dtype] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        points = _points_tensor(points, dtype, device)
        if points.ndim != 2:
            raise ValueError(f"points must have rank 2, got shape {tuple(points.shape)}")
        self._points = points

    @property
    def points(self) -> torch.Tensor:
        """All points, ``[N, D]``."""
        return self._points

    @property
    def dtype(self) -> torch.dtype:
        return self._points.dtype

    @property
    def device(self) -> torch.device:
        return self._points.device

    @property
    def dimension(self) -> int:
        return self._points.shape[-1]

    @property
    def lower(self) -> torch.Tensor:
        return torch.amin(self._points, dim=0)

    @property
    def upper(self) -> torch.Tensor:
        return torch.amax(self._points, dim=0)

    def _contains(self, value: torch.Tensor) -> torch.Tensor:
        points = self._points.to(value.device)
        return torch.any(torch.all(value[..., None, :] == points, dim=-1), dim=-1)

    def sample(self, generator: Optional[torch.Generator], num_samples: int) -> torch.Tensor:
        """Points drawn uniformly with replacement; ``generator`` lives on the space's device."""
        idx = torch.randint(
            0, self._points.shape[0], (num_samples,), generator=generator, device=self.device
        )
        return self._points[idx]

    def one_hot_encoder(self) -> Optional[EncoderFunction]:
        return None

    def __mul__(self, other: SearchSpace) -> SearchSpace:
        if isinstance(other, GeneralDiscreteSearchSpace):
            n, m = self._points.shape[0], other._points.shape[0]
            left = torch.repeat_interleave(self._points, m, dim=0)
            right = other._points.to(left.device).repeat(n, 1)
            return DiscreteSearchSpace(torch.cat([left, right.to(left.dtype)], dim=-1))
        return TaggedProductSearchSpace([self, other])

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, type(self))
            and self._points.shape == other._points.shape
            and bool(torch.equal(self._points.cpu(), other._points.cpu()))
        )

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._points!r})"


class DiscreteSearchSpace(GeneralDiscreteSearchSpace):
    """A discrete space of numeric points."""


class CategoricalSearchSpace(GeneralDiscreteSearchSpace, HasOneHotEncoder):
    """A categorical space: each dimension takes one of a finite set of named categories,
    represented by the category's index. ``categories`` is a number of categories (one
    dimension), a list of names (one dimension), a list of numbers (one dimension each)
    or a list of lists of names."""

    def __init__(
        self,
        categories: Union[int, Sequence[str], Sequence[int], Sequence[Sequence[str]]],
        dtype: Optional[torch.dtype] = None,
        *,
        device: Union[str, torch.device] = "cuda",
    ):
        if isinstance(categories, int):
            categories = [categories]
        if len(categories) == 0:
            raise ValueError("CategoricalSearchSpace needs at least one dimension")
        tags: list[Tuple[str, ...]] = []
        first = categories[0]
        if isinstance(first, str):
            tags = [tuple(str(c) for c in categories)]
        elif isinstance(first, (int, np.integer)):
            for size in categories:
                if int(size) <= 0:
                    raise ValueError("category sizes must be positive")
                tags.append(tuple(str(i) for i in range(int(size))))
        else:
            for cats in categories:
                if len(cats) == 0:
                    raise ValueError("each dimension needs at least one category")
                tags.append(tuple(str(c) for c in cats))
        self._tags = tags
        dtype = dtype or default_float()
        grids = [torch.arange(len(t), dtype=dtype, device=device) for t in tags]
        mesh = torch.meshgrid(*grids, indexing="ij")
        super().__init__(torch.stack([m.reshape(-1) for m in mesh], dim=-1))

    @property
    def tags(self) -> Sequence[Tuple[str, ...]]:
        """Category names per dimension."""
        return self._tags

    def to_tags(self, points: TensorType) -> list[list[str]]:
        """Category names of index points."""
        pts = points.detach().cpu().numpy() if isinstance(points, torch.Tensor) else np.asarray(points)
        if not np.all(pts == np.round(pts)):
            raise ValueError(f"to_tags requires integral indices, got {pts}")
        return [[self._tags[d][int(v)] for d, v in enumerate(row)]
                for row in pts.reshape(-1, pts.shape[-1])]

    def one_hot_encoder(self) -> EncoderFunction:
        """One-hot encoder; a dimension with at most two categories stays one 0/1 column."""
        tags = self._tags

        def encoder(x: torch.Tensor) -> torch.Tensor:
            cols = []
            for d, t in enumerate(tags):
                if len(t) <= 2:
                    cols.append(x[..., d : d + 1])
                else:
                    one_hot = torch.nn.functional.one_hot(x[..., d].long(), len(t))
                    cols.append(one_hot.to(x.dtype))
            return torch.cat(cols, dim=-1)

        return encoder

    def __mul__(self, other: SearchSpace) -> SearchSpace:
        if isinstance(other, CategoricalSearchSpace):
            return CategoricalSearchSpace(
                list(self._tags) + list(other._tags), self.dtype, device=self.device
            )
        return TaggedProductSearchSpace([self, other])

    def __eq__(self, other: object) -> bool:
        # the category names are part of the space, not only the index points
        return (
            isinstance(other, CategoricalSearchSpace)
            and self._tags == other._tags
            and super().__eq__(other)
        )


class Box(SearchSpace):
    """A continuous box ``[lower, upper]`` on one device.

    The bounds are kept on the host (numpy) and become tensors on ``device`` when read,
    so a box can be built where no card is present. Zero-width dimensions are valid. The
    box's constraints are moved to its device and dtype when first read, for the same
    reason.
    """

    def __init__(
        self,
        lower: TensorType,
        upper: TensorType,
        constraints: Optional[Sequence[Constraint]] = None,
        *,
        dtype: Optional[torch.dtype] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        if isinstance(lower, torch.Tensor):
            lower = lower.detach().cpu().numpy()
        if isinstance(upper, torch.Tensor):
            upper = upper.detach().cpu().numpy()
        lower = np.array(lower, np.float64)  # copies: the box owns its bounds
        upper = np.array(upper, np.float64)
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
        self._constraints = list(constraints or [])  # as given: products and ``to`` use them
        self._placed: Optional[list[Constraint]] = None

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def constraints(self) -> Sequence[Constraint]:
        if self._placed is None:
            self._placed = [c.to(self._device, self._dtype) for c in self._constraints]
        return self._placed

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
            self._lower, self._upper, self._constraints, dtype=dtype or self._dtype,
            device=device or self._device,
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

    # -- feasible sampling by rejection -------------------------------------------------

    def _sample_feasible_loop(
        self, num_samples: int, sampler: Callable[[int], torch.Tensor], max_tries: int
    ) -> torch.Tensor:
        """The first ``num_samples`` feasible points, in draw order, of up to ``max_tries``
        draws of ``num_samples`` candidates each."""
        feasible, total = [], 0
        for _ in range(max_tries):
            candidates = sampler(num_samples)
            keep = candidates[self.is_feasible(candidates)]
            feasible.append(keep)
            total += keep.shape[0]
            if total >= num_samples:
                return torch.cat(feasible)[:num_samples]
        raise SampleTimeoutError(
            f"failed to sample {num_samples} feasible points in {max_tries} tries"
        )

    def sample_feasible(
        self, generator: Optional[torch.Generator], num_samples: int, max_tries: int = 100
    ) -> torch.Tensor:
        """Uniform samples of the feasible region, by rejection (each try draws
        ``num_samples`` candidates); without constraints, :meth:`sample`."""
        if not self.has_constraints:
            return self.sample(generator, num_samples)
        return self._sample_feasible_loop(
            num_samples, lambda n: self.sample(generator, n), max_tries
        )

    def sample_halton_feasible(
        self, generator: Optional[torch.Generator], num_samples: int, max_tries: int = 100
    ) -> torch.Tensor:
        """Halton samples of the feasible region, each try with its own rotation."""
        if not self.has_constraints:
            return self.sample_halton(generator, num_samples)
        return self._sample_feasible_loop(
            num_samples, lambda n: self.sample_halton(generator, n), max_tries
        )

    def sample_sobol_feasible(
        self, num_samples: int, skip: Optional[int] = None, max_tries: int = 100
    ) -> torch.Tensor:
        """Sobol samples of the feasible region: each try continues the sequence where the
        last one stopped."""
        if not self.has_constraints:
            return self.sample_sobol(num_samples, skip)
        skips = iter(range(skip or 0, (skip or 0) + max_tries * num_samples, num_samples))
        return self._sample_feasible_loop(
            num_samples, lambda n: self.sample_sobol(n, skip=next(skips)), max_tries
        )

    def __mul__(self, other: SearchSpace) -> SearchSpace:
        if not isinstance(other, Box):
            return TaggedProductSearchSpace([self, other])
        d1, d2 = self.dimension, other.dimension
        constraints = [c.shift(0, d1, d1 + d2) for c in self._constraints] + [
            c.shift(d1, d2, d1 + d2) for c in other._constraints
        ]
        return Box(
            np.concatenate([self._lower, other._lower]),
            np.concatenate([self._upper, other._upper]),
            constraints,
            dtype=self._dtype,
            device=self._device,
        )

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Box)
            and bool(np.array_equal(self._lower, other._lower))
            and bool(np.array_equal(self._upper, other._upper))
            and list(self._constraints) == list(other._constraints)
        )

    def __repr__(self) -> str:
        return f"Box({self._lower!r}, {self._upper!r}, device={str(self._device)!r})"


def _default_tags(n: int) -> list[str]:
    return [str(i) for i in range(n)]


class CollectionSearchSpace(SearchSpace):
    """A collection of tagged subspaces, all on one device."""

    def __init__(self, spaces: Sequence[SearchSpace], tags: Optional[Sequence[str]] = None):
        if tags is None:
            tags = _default_tags(len(spaces))
        if len(tags) != len(spaces):
            raise ValueError(f"got {len(tags)} tags for {len(spaces)} spaces")
        if len(set(tags)) != len(tags):
            raise ValueError(f"tags must be unique, got {tags}")
        devices = [s.device for s in spaces]
        if any(not _same_device(d, devices[0]) for d in devices):
            raise ValueError(f"the subspaces live on different devices: {devices}")
        self._spaces: dict[str, SearchSpace] = dict(zip(tags, spaces))
        self._tags = tuple(tags)

    @property
    def subspace_tags(self) -> Tuple[str, ...]:
        return self._tags

    def get_subspace(self, tag: str) -> SearchSpace:
        if tag not in self._spaces:
            raise ValueError(f"unknown subspace tag {tag!r}; have {self._tags}")
        return self._spaces[tag]

    @property
    def device(self) -> torch.device:
        return next(iter(self._spaces.values())).device


def _promoted_cat(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    dtype = parts[0].dtype
    for p in parts[1:]:
        dtype = torch.promote_types(dtype, p.dtype)
    return torch.cat([p.to(dtype) for p in parts], dim=dim)


class TaggedProductSearchSpace(CollectionSearchSpace, HasOneHotEncoder):
    """A product of heterogeneous subspaces laid out along the feature axis."""

    def __init__(self, spaces: Sequence[SearchSpace], tags: Optional[Sequence[str]] = None):
        super().__init__(spaces, tags)
        dims = [s.dimension for s in self._spaces.values()]
        self._subspace_sizes = dims
        self._subspace_starts = [int(x) for x in np.cumsum([0] + dims[:-1])]
        self._dimension = int(sum(dims))

    @property
    def dimension(self) -> int:
        return self._dimension

    @property
    def lower(self) -> torch.Tensor:
        return _promoted_cat([s.lower for s in self._spaces.values()], 0)

    @property
    def upper(self) -> torch.Tensor:
        return _promoted_cat([s.upper for s in self._spaces.values()], 0)

    def subspace_dimension_range(self, tag: str) -> Tuple[int, int]:
        i = self._tags.index(tag)
        start = self._subspace_starts[i]
        return start, start + self._subspace_sizes[i]

    def get_subspace_component(self, tag: str, values: torch.Tensor) -> torch.Tensor:
        """One subspace's columns of ``values``."""
        lo, hi = self.subspace_dimension_range(tag)
        return values[..., lo:hi]

    def _contains(self, value: torch.Tensor) -> torch.Tensor:
        parts = [
            self._spaces[t]._contains(self.get_subspace_component(t, value)) for t in self._tags
        ]
        return torch.all(torch.stack(parts, dim=-1), dim=-1)

    def sample(self, generator: Optional[torch.Generator], num_samples: int) -> torch.Tensor:
        """Each subspace sampled in turn from ``generator``, the parts concatenated."""
        return _promoted_cat(
            [self._spaces[t].sample(generator, num_samples) for t in self._tags], -1
        )

    def fix_subspace(self, tag: str, values: TensorType) -> "TaggedProductSearchSpace":
        """This product with one subspace replaced by a single fixed point."""
        fixed = torch.atleast_2d(_points_tensor(values, None, self.device))
        return TaggedProductSearchSpace(
            [DiscreteSearchSpace(fixed) if t == tag else self._spaces[t] for t in self._tags],
            self._tags,
        )

    def one_hot_encoder(self) -> Optional[EncoderFunction]:
        encoders = [getattr(self._spaces[t], "one_hot_encoder", lambda: None)() for t in self._tags]
        if all(e is None for e in encoders):
            return None
        ranges = [self.subspace_dimension_range(t) for t in self._tags]

        def encoder(x: torch.Tensor) -> torch.Tensor:
            parts = [x[..., lo:hi] if enc is None else enc(x[..., lo:hi])
                     for (lo, hi), enc in zip(ranges, encoders)]
            return torch.cat(parts, dim=-1)

        return encoder

    def __mul__(self, other: SearchSpace) -> SearchSpace:
        return TaggedProductSearchSpace([self, other])

    def __repr__(self) -> str:
        return f"TaggedProductSearchSpace({dict(self._spaces)!r})"


class TaggedMultiSearchSpace(CollectionSearchSpace):
    """V subspaces of one dimension as one vectorized acquisition space: ``sample``
    returns ``[n, V, D]``, the bounds are ``[V, D]`` and ``contains`` maps ``[..., V, D]``
    to ``[..., V]``. It is the acquisition space of a trust-region fleet."""

    def __init__(self, spaces: Sequence[SearchSpace], tags: Optional[Sequence[str]] = None):
        if len(spaces) == 0:
            raise ValueError("need at least one subspace")
        dims = {s.dimension for s in spaces}
        if len(dims) != 1:
            raise ValueError(f"all subspaces must share a dimension, got {dims}")
        super().__init__(spaces, tags)

    @property
    def dimension(self) -> int:
        return next(iter(self._spaces.values())).dimension

    @property
    def num_subspaces(self) -> int:
        return len(self._tags)

    @property
    def lower(self) -> torch.Tensor:
        """``[V, D]`` stacked lower bounds."""
        return torch.stack([s.lower for s in self._spaces.values()])

    @property
    def upper(self) -> torch.Tensor:
        return torch.stack([s.upper for s in self._spaces.values()])

    def sample(self, generator: Optional[torch.Generator], num_samples: int) -> torch.Tensor:
        """Each subspace sampled in turn from ``generator``, stacked on axis 1."""
        return torch.stack(
            [self._spaces[t].sample(generator, num_samples) for t in self._tags], dim=1
        )

    def _contains(self, value: torch.Tensor) -> torch.Tensor:
        parts = [self._spaces[t]._contains(value[..., i, :]) for i, t in enumerate(self._tags)]
        return torch.stack(parts, dim=-1)

    def contains(self, value: torch.Tensor) -> torch.Tensor:
        if value.shape[-1] != self.dimension or value.shape[-2] != self.num_subspaces:
            raise ValueError(
                f"expected [..., {self.num_subspaces}, {self.dimension}], got {tuple(value.shape)}"
            )
        return self._contains(value)

    def __mul__(self, other: SearchSpace) -> SearchSpace:
        raise NotImplementedError("products of multi-spaces are not supported")


def one_hot_encoder(space: SearchSpace) -> EncoderFunction:
    """The space's one-hot encoder, or the identity where it has none."""
    enc = getattr(space, "one_hot_encoder", lambda: None)()
    return (lambda x: x) if enc is None else enc


def cast_encoder(encoder: EncoderFunction, dtype: torch.dtype) -> EncoderFunction:
    """``encoder`` followed by a cast to ``dtype``."""
    return lambda x: encoder(x).to(dtype)


def one_hot_encoded_space(space: SearchSpace) -> SearchSpace:
    """The space of the one-hot encoding of ``space``: a categorical (sub)space becomes a
    discrete space of its encoded points; every other space stays as it is."""
    enc = getattr(space, "one_hot_encoder", lambda: None)()
    if isinstance(space, GeneralDiscreteSearchSpace) and enc is not None:
        return DiscreteSearchSpace(enc(space.points))
    if isinstance(space, TaggedProductSearchSpace):
        return TaggedProductSearchSpace(
            [one_hot_encoded_space(space.get_subspace(t)) for t in space.subspace_tags],
            list(space.subspace_tags),
        )
    if enc is not None:
        raise NotImplementedError(f"unsupported one-hot-encoded space {type(space)}")
    return space
