"""Deep ensembles of probabilistic MLPs (counterpart of
:mod:`trieste_tpu.models.ensembles.deep_ensemble`).

One :class:`GaussianMLP` holds the weights of all ``E`` members, stacked on a leading
``[E]`` axis of every tensor, and evaluates them with batched products, as the JAX package
vmaps one flax network over that axis. The kernels keep flax's ``[d_in, d_out]`` layout,
the transpose of ``nn.Linear.weight``, so that parameters carry across as they are
(:func:`~trieste_tpu_torch.convert.deep_ensemble_from_numpy`). The members train together:
one Adam over the stacked tensors on the sum of the members' losses is each member's own
Adam, since Adam is elementwise and member e's loss depends on its slice alone
(:func:`~trieste_tpu_torch.ops.adam.adam_minimize`, one CUDA graph per fit on the card).

Every function that draws is split in two: a draw from a ``torch.Generator`` and a pure
function of it (the bootstrap's indices, a sample's members and head noise, a trajectory's).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ...data import Dataset
from ...ops.adam import adam_minimize
from ...utils.misc import generator_for, standard_normal
from ..interfaces import (
    ReparametrizationSampler,
    TrajectoryFunction,
    TrajectoryFunctionClass,
    TrajectorySampler,
)

TRUNCATED_NORMAL_STD = 0.87962566103423978
"""The standard deviation of a standard normal truncated to [-2, 2]: flax's LeCun-normal
initializer divides by it so that its kernels have variance ``1 / fan_in``."""


class GaussianMLP(nn.Module):
    """``E`` MLPs with an independent-Gaussian head, stacked: ``x -> (mean, variance)``,
    the variance ``softplus(raw) + 1e-6``. Layer i has a kernel ``[E, d_in, d_out]`` and a
    bias ``[E, d_out]`` (flax's ``Dense_i``): ReLU layers, then the mean head and the raw
    variance head. The weights do not require grad; a fit trains a copy."""

    def __init__(self, kernels: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]):
        super().__init__()
        if len(kernels) < 3 or len(kernels) != len(biases):
            raise ValueError("need a kernel and a bias for each hidden layer and both heads")
        self.kernels = nn.ParameterList([nn.Parameter(k, requires_grad=False) for k in kernels])
        self.biases = nn.ParameterList([nn.Parameter(b, requires_grad=False) for b in biases])

    @property
    def ensemble_size(self) -> int:
        return self.kernels[0].shape[0]

    @property
    def hidden_units(self) -> Tuple[int, ...]:
        return tuple(k.shape[-1] for k in self.kernels[:-2])

    def forward(
        self, x: torch.Tensor, members: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x [N, D]``, one input for every member, or ``[E', N, D]``, one per member:
        all ``E`` or, given ``members [E']``, those (with repeats). Returns the mean and the
        variance, each ``[E', N, L]``."""
        kernels, biases = list(self.kernels), list(self.biases)
        if members is not None:
            kernels = [k[members] for k in kernels]
            biases = [b[members] for b in biases]
        h = x.expand((kernels[0].shape[0],) + x.shape) if x.ndim == 2 else x
        for k, b in zip(kernels[:-2], biases[:-2]):
            h = torch.relu(torch.baddbmm(b[:, None, :], h, k))
        mean = torch.baddbmm(biases[-2][:, None, :], h, kernels[-2])
        raw = torch.baddbmm(biases[-1][:, None, :], h, kernels[-1])
        return mean, torch.logaddexp(raw, raw.new_zeros(())) + 1e-6


def init_gaussian_mlp(
    generator: Optional[torch.Generator],
    ensemble_size: int,
    input_dim: int,
    hidden_units: Sequence[int],
    output_dim: int,
    *,
    dtype: torch.dtype,
    device: torch.device,
) -> GaussianMLP:
    """Fresh members as flax initializes a ``Dense``: kernels from a normal truncated to
    two standard deviations with variance ``1 / d_in`` (LeCun, fan-in), biases zero."""
    dims = [input_dim, *hidden_units]
    shapes = list(zip(dims[:-1], dims[1:])) + [(dims[-1], output_dim)] * 2
    generator = generator_for(generator, device)
    kernels, biases = [], []
    for d_in, d_out in shapes:
        k = torch.empty((ensemble_size, d_in, d_out), dtype=dtype, device=device)
        nn.init.trunc_normal_(k, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
        kernels.append(k * (math.sqrt(1.0 / d_in) / TRUNCATED_NORMAL_STD))
        biases.append(torch.zeros((ensemble_size, d_out), dtype=dtype, device=device))
    return GaussianMLP(kernels, biases)


@dataclass(frozen=True)
class DeepEnsembleParams:
    """The stacked members and the normalization of inputs and outputs."""

    member_params: GaussianMLP
    x_mean: torch.Tensor
    x_std: torch.Tensor
    y_mean: torch.Tensor
    y_std: torch.Tensor

    def replace(self, **changes) -> "DeepEnsembleParams":
        return dataclasses.replace(self, **changes)


def _nll_loss(
    mean: torch.Tensor, var: torch.Tensor, y: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """The Gaussian negative log likelihood of ``y [N, L]`` under ``mean, var [..., N, L]``,
    weighted by ``w [..., N]`` and divided by ``max(Σw, 1)``: ``[...]``."""
    nll = 0.5 * (torch.log(2.0 * math.pi * var) + torch.square(y - mean) / var)
    return torch.sum(nll * w[..., None], dim=(-2, -1)) / torch.clamp_min(torch.sum(w, dim=-1), 1.0)


class DeepEnsembleTrainingResult(NamedTuple):
    params: DeepEnsembleParams
    loss: torch.Tensor  # the mean of the members' losses at the last step
    num_nonfinite: torch.Tensor  # member losses that were not finite, over all steps


def _normalize(params: DeepEnsembleParams, x: torch.Tensor) -> torch.Tensor:
    return (x - params.x_mean) / params.x_std


def ensemble_member_predict(
    params: DeepEnsembleParams, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each member's denormalized mean and variance at ``x [..., D]``: two ``[E, ..., L]``."""
    lead = x.shape[:-1]
    mean, var = params.member_params(_normalize(params, x.reshape(-1, x.shape[-1])))
    E, L = mean.shape[0], mean.shape[-1]
    return (
        (mean * params.y_std + params.y_mean).reshape((E,) + lead + (L,)),
        (var * torch.square(params.y_std)).reshape((E,) + lead + (L,)),
    )


def ensemble_predict(
    params: DeepEnsembleParams, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The moments of the members' Gaussian mixture at ``x [..., D]``: two ``[..., L]``,
    the variance floored at 1e-12."""
    means, vars_ = ensemble_member_predict(params, x)
    mix_mean = torch.mean(means, dim=0)
    mix_var = torch.mean(vars_ + torch.square(means), dim=0) - torch.square(mix_mean)
    return mix_mean, torch.clamp_min(mix_var, 1e-12)


def _moments(A: torch.Tensor, m: torch.Tensor, n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The population mean and standard deviation of the valid rows of ``A [C, K]``, the
    deviation floored at ``sqrt(1e-12)``."""
    mean = torch.sum(A * m[:, None], dim=0) / torch.clamp_min(n, 1.0)
    var = torch.sum(torch.square(A - mean) * m[:, None], dim=0) / torch.clamp_min(n, 1.0)
    return mean, torch.sqrt(torch.clamp_min(var, 1e-12))


def bootstrap_indices(
    generator: Optional[torch.Generator], mask: torch.Tensor, ensemble_size: int
) -> torch.Tensor:
    """Each member's bootstrap resample: ``[E, C]`` indices of valid rows, drawn uniformly
    with replacement, ``C`` (the capacity) per member as the JAX package draws them. With no
    valid row any row is drawn; its weight is masked to 0."""
    generator = generator_for(generator, mask.device)
    C = mask.shape[0]
    weights = torch.where(mask.any(), mask.to(torch.float32), torch.ones(C, device=mask.device))
    return torch.multinomial(weights.expand(ensemble_size, C), C, replacement=True,
                             generator=generator)


def fit_deep_ensemble_from_indices(
    indices: Optional[torch.Tensor],
    params: DeepEnsembleParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask: torch.Tensor,
    *,
    num_steps: int = 1000,
    learning_rate: float = 0.01,
) -> DeepEnsembleTrainingResult:
    """Train all members at once on the valid rows, normalized by their moments: member e
    weights row i by the number of times ``indices [E, C]`` draws it (its bootstrap
    resample), or by 1 with ``indices=None``. ``params`` is not changed."""
    m = mask.to(X.dtype)
    n = torch.sum(m)
    x_mean, x_std = _moments(X, m, n)
    y_mean, y_std = _moments(Y, m, n)
    Xn, Yn = (X - x_mean) / x_std, (Y - y_mean) / y_std
    network = copy.deepcopy(params.member_params)
    E, C = network.ensemble_size, X.shape[0]
    if indices is None:
        weights = m.expand(E, C)
    else:
        counts = torch.zeros((E, C), dtype=X.dtype, device=X.device)
        weights = counts.scatter_add_(1, indices, torch.ones_like(counts)) * m[None, :]
    leaves = [p.requires_grad_(True) for p in network.parameters()]

    def loss_fn() -> torch.Tensor:
        mean, var = network(Xn)
        return _nll_loss(mean, var, Yn, weights)  # [E]

    losses, nonfinite = adam_minimize(leaves, loss_fn, num_steps, learning_rate)
    for p in leaves:
        p.requires_grad_(False)
    fitted = params.replace(member_params=network, x_mean=x_mean, x_std=x_std, y_mean=y_mean,
                            y_std=y_std)
    return DeepEnsembleTrainingResult(fitted, torch.mean(losses), nonfinite)


def fit_deep_ensemble(
    generator: Optional[torch.Generator],
    params: DeepEnsembleParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask: torch.Tensor,
    *,
    num_steps: int = 1000,
    learning_rate: float = 0.01,
    bootstrap: bool = True,
) -> DeepEnsembleTrainingResult:
    """:func:`fit_deep_ensemble_from_indices` on a bootstrap drawn from ``generator``, or
    on every valid row once with ``bootstrap=False``."""
    E = params.member_params.ensemble_size
    indices = bootstrap_indices(generator, mask, E) if bootstrap else None
    return fit_deep_ensemble_from_indices(indices, params, X, Y, mask, num_steps=num_steps,
                                          learning_rate=learning_rate)


def sample_from_draws(
    means: torch.Tensor, vars_: torch.Tensor, index: torch.Tensor, eps: torch.Tensor
) -> torch.Tensor:
    """Draw s from member ``index[s]``'s Gaussian head: ``[S, ..., L]`` from the members'
    moments ``[E, ..., L]`` and standard normals ``eps [S, ..., L]``."""
    return means[index] + torch.sqrt(vars_[index]) * eps


class DeepEnsemble:
    """A deep ensemble. Implements ``TrainableProbabilisticModel``, ``SupportsPredictY``,
    ``SupportsGetInternalData``, ``HasTrajectorySampler`` and ``HasReparamSampler`` (the
    marginal sampler). ``optimize`` draws each fit's bootstrap from the model's generator."""

    def __init__(
        self,
        params: DeepEnsembleParams,
        dataset: Dataset,
        *,
        num_train_steps: int = 1000,
        learning_rate: float = 0.01,
        bootstrap: bool = True,
        optimize_generator: Optional[torch.Generator] = None,
    ):
        self._params = params
        self._dataset = dataset
        self._num_train_steps = num_train_steps
        self._learning_rate = learning_rate
        self._bootstrap = bootstrap
        if optimize_generator is None:
            optimize_generator = torch.Generator(device=dataset.device).manual_seed(0)
        self._generator = optimize_generator

    @property
    def params(self) -> DeepEnsembleParams:
        return self._params

    @property
    def ensemble_size(self) -> int:
        return self._params.member_params.ensemble_size

    @property
    def num_networks(self) -> int:
        return self.ensemble_size

    def get_internal_data(self) -> Dataset:
        return self._dataset

    def predict(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return ensemble_predict(self._params, query_points)

    def predict_ensemble(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each member's mean and variance, ``[E, ..., L]``."""
        return ensemble_member_predict(self._params, query_points)

    def predict_y(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`predict`: the members' variances are already those of observations."""
        return self.predict(query_points)

    def sample(
        self, generator: Optional[torch.Generator], query_points: torch.Tensor, num_samples: int
    ) -> torch.Tensor:
        """``[S, ..., L]`` draws from the mixture: a uniformly chosen member each, then its
        Gaussian head."""
        means, vars_ = self.predict_ensemble(query_points)
        generator = generator_for(generator, means.device)
        index = torch.randint(0, self.ensemble_size, (num_samples,), generator=generator,
                              device=means.device)
        eps = standard_normal(generator, (num_samples,) + means.shape[1:], means)
        return sample_from_draws(means, vars_, index, eps)

    def sample_ensemble(
        self, generator: Optional[torch.Generator], query_points: torch.Tensor, num_samples: int
    ) -> torch.Tensor:
        """``[S, ..., L]``: the means of uniformly chosen members."""
        means, _ = self.predict_ensemble(query_points)
        generator = generator_for(generator, means.device)
        index = torch.randint(0, self.ensemble_size, (num_samples,), generator=generator,
                              device=means.device)
        return means[index]

    def update(self, dataset: Dataset) -> None:
        self._dataset = dataset

    def optimize(self, dataset: Dataset) -> DeepEnsembleTrainingResult:
        result = fit_deep_ensemble(
            self._generator, self._params, dataset.query_points, dataset.observations,
            dataset.mask, num_steps=self._num_train_steps, learning_rate=self._learning_rate,
            bootstrap=self._bootstrap,
        )
        self._params = result.params
        self._dataset = dataset
        return result

    def trajectory_sampler(self) -> TrajectorySampler:
        return DeepEnsembleTrajectorySampler(self)

    def reparam_sampler(self, num_samples: int) -> ReparametrizationSampler:
        from ..gp.sampler import IndependentReparametrizationSampler

        return IndependentReparametrizationSampler(num_samples, self)

    def log(self, dataset: Optional[Dataset] = None) -> None:
        """Nothing is logged, as in the JAX package."""

    def __repr__(self) -> str:
        return f"DeepEnsemble(E={self.ensemble_size})"


class _EnsembleTrajectory(TrajectoryFunctionClass):
    """Column b is member ``indices[b]``'s mean plus its standard deviation times the
    frozen head noise ``eps[b]`` (zeros unless diversified): ``[N, B, D] -> [N, B, L]``."""

    def __init__(self, params: DeepEnsembleParams, indices: torch.Tensor, eps: torch.Tensor):
        self.params = params
        self.indices = indices  # [B]
        self.eps = eps  # [B, L]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        p = self.params
        mean, var = p.member_params(_normalize(p, x.transpose(0, 1)), members=self.indices)
        mean = mean * p.y_std + p.y_mean
        var = var * torch.square(p.y_std)
        return (mean + torch.sqrt(var) * self.eps[:, None, :]).transpose(0, 1)


class DeepEnsembleTrajectorySampler(TrajectorySampler):
    """Draws a member for each batch column and, with ``diversify``, its head noise."""

    def __init__(self, model: DeepEnsemble, diversify: bool = False):
        super().__init__(model)
        self._diversify = diversify

    def get_trajectory(
        self, generator: Optional[torch.Generator], batch_size: int = 1
    ) -> TrajectoryFunction:
        model: DeepEnsemble = self._model
        data = model.get_internal_data()
        generator = generator_for(generator, data.device)
        indices = torch.randint(0, model.ensemble_size, (batch_size,), generator=generator,
                                device=data.device)
        like = data.observations
        if self._diversify:
            eps = standard_normal(generator, (batch_size, data.num_outputs), like)
        else:
            eps = like.new_zeros((batch_size, data.num_outputs))
        return _EnsembleTrajectory(model.params, indices, eps)


def build_deep_ensemble(
    dataset: Dataset,
    *,
    ensemble_size: int = 5,
    hidden_units: Sequence[int] = (25, 25),
    num_train_steps: int = 1000,
    learning_rate: float = 0.01,
    bootstrap: bool = True,
    generator: Optional[torch.Generator] = None,
) -> DeepEnsemble:
    """A deep ensemble of fresh members on the dataset's device and dtype. ``generator``
    (default: seeded 0 on that device) draws the weights and then each fit's bootstrap."""
    if ensemble_size < 2:
        raise ValueError(f"ensemble_size must be at least 2, got {ensemble_size}")
    if not hidden_units:
        raise ValueError("need at least one hidden layer")
    dtype, device = dataset.query_points.dtype, dataset.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    network = init_gaussian_mlp(generator, ensemble_size, dataset.dimension, hidden_units,
                                dataset.num_outputs, dtype=dtype, device=device)
    D, L = dataset.dimension, dataset.num_outputs
    params = DeepEnsembleParams(
        member_params=network,
        x_mean=torch.zeros(D, dtype=dtype, device=device),
        x_std=torch.ones(D, dtype=dtype, device=device),
        y_mean=torch.zeros(L, dtype=dtype, device=device),
        y_std=torch.ones(L, dtype=dtype, device=device),
    )
    return DeepEnsemble(params, dataset, num_train_steps=num_train_steps,
                        learning_rate=learning_rate, bootstrap=bootstrap,
                        optimize_generator=generator)
