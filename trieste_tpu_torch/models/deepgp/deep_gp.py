"""Doubly-stochastic deep GP (counterpart of :mod:`trieste_tpu.models.deepgp.deep_gp`).

A stack of whitened sparse-variational GP layers trained by doubly-stochastic variational
inference (Salimbeni and Deisenroth): inner layers add an identity mean (a skip
connection), the output layer a constant. A sample propagates through the stack, each
layer drawing from its marginal at the previous layer's sample.

The propagation takes its standard normals as an input: ``noise [S, N, W]`` holds each
layer's ``d_out`` columns side by side (``W`` their sum), and the drawing functions draw
it from a ``torch.Generator``. ``fit_dgp`` draws the noise of its Adam steps in blocks of
steps under :data:`FIT_NOISE_BLOCK_BYTES`, outside the step, which copies its own into a
fixed buffer: on the card one CUDA graph of the step then replays them all
(:func:`~trieste_tpu_torch.ops.adam.adam_minimize`). A propagation over many rows and
samples runs over chunks of samples whose per-layer intermediates stay under
:data:`PROPAGATE_CHUNK_BYTES`.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ...data import Dataset
from ...ops.adam import adam_minimize
from ...ops.kernels import Stationary, gram, stationary
from ...ops.linalg import nan_cholesky, solve_lower
from ...utils.misc import flatten_leading_dims, generator_for, jitter_for, standard_normal
from ..gp.training import NOISE_FLOOR
from ..interfaces import (
    ReparametrizationSampler,
    TrajectoryFunction,
    TrajectoryFunctionClass,
    TrajectorySampler,
)

PREDICT_SEED = 7
"""The seed of every prediction's noise: ``predict`` is a deterministic function of its
input, as an acquisition optimizer's line search needs."""

PROPAGATE_CHUNK_BYTES = 2**30
"""Most bytes of one layer's intermediates (``Kux``, ``A`` and ``SA`` for a chunk of
samples) in a propagation: a larger one runs over chunks of samples."""

FIT_NOISE_BLOCK_BYTES = 2**28
"""Most bytes of propagation noise that ``fit_dgp`` holds at once: it draws the noise of as
many steps as fit in this (one step's at least), and the next block when those are spent."""


@dataclass(frozen=True)
class DGPLayerParams:
    """One whitened SVGP layer ``f(x) = mean_fn(x) + g(x)``, ``g ~ SVGP(q)``. ``q_sqrt
    [d_out, M, M]`` is a free matrix whose lower triangle is the Cholesky factor: every
    consumer takes ``torch.tril`` of it."""

    kernel: Stationary
    inducing_points: torch.Tensor  # [M, d_in]
    q_mu: torch.Tensor  # [M, d_out]
    q_sqrt: torch.Tensor  # [d_out, M, M]

    def replace(self, **changes) -> "DGPLayerParams":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class DGPParams:
    layers: Tuple[DGPLayerParams, ...]
    noise_variance: torch.Tensor
    mean_constant: torch.Tensor

    def replace(self, **changes) -> "DGPParams":
        return dataclasses.replace(self, **changes)

    @property
    def noise_width(self) -> int:
        """``W``: the columns of propagation noise a sample takes at each row."""
        return sum(layer.q_mu.shape[-1] for layer in self.layers)


def _layer_moments(
    layer: DGPLayerParams, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's marginal mean and variance at ``x [..., N, d_in]``: two
    ``[..., N, d_out]``, the variance floored at 1e-24."""
    Z = layer.inducing_points
    M = Z.shape[0]
    Kuu = gram(layer.kernel, Z) + jitter_for(x.dtype) * torch.eye(M, dtype=x.dtype, device=x.device)
    L = nan_cholesky(Kuu)
    Kux = gram(layer.kernel, Z, x)  # [..., M, N]
    A = solve_lower(L, Kux)  # [..., M, N]
    mean = A.transpose(-1, -2) @ layer.q_mu  # [..., N, d_out]
    SA = torch.einsum("pmk,...mn->...pkn", torch.tril(layer.q_sqrt), A)  # [..., d_out, M, N]
    # the sums of squares as squared norms: no temporary the size of SA
    var = (
        layer.kernel.diag(x)[..., None, :]
        - torch.square(torch.linalg.vector_norm(A, dim=-2))[..., None, :]
        + torch.square(torch.linalg.vector_norm(SA, dim=-2))
    )  # [..., d_out, N]
    return mean, torch.clamp_min(var.transpose(-1, -2), 1e-24)


def _identity_mean(x: torch.Tensor, d_out: int) -> torch.Tensor:
    """``x``'s first ``d_out`` columns, padded with zeros where it has fewer."""
    d_in = x.shape[-1]
    if d_in == d_out:
        return x
    if d_in > d_out:
        return x[..., :d_out]
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (d_out - d_in,))], dim=-1)


def _propagate(params: DGPParams, h: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    num_layers = len(params.layers)
    start = 0
    for i, layer in enumerate(params.layers):
        d_out = layer.q_mu.shape[-1]
        mean, var = _layer_moments(layer, h)
        g = mean + torch.sqrt(var) * noise[..., start:start + d_out]
        start += d_out
        h = _identity_mean(h, d_out) + g if i < num_layers - 1 else params.mean_constant + g
    return h


def _sample_chunk(params: DGPParams, S: int, N: int, itemsize: int) -> int:
    """Samples per chunk: one sample's widest layer holds ``A`` and ``SA`` and, before
    them, the Gram's temporaries, some ``(d_out + 2)·M·N`` elements at most."""
    per_sample = max((l.q_mu.shape[-1] + 2) * l.inducing_points.shape[0] for l in params.layers)
    return max(1, min(S, PROPAGATE_CHUNK_BYTES // max(per_sample * N * itemsize, 1)))


def dgp_propagate_from_noise(
    params: DGPParams, x: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """``S`` sampled paths through the stack from the standard normals ``noise [S, N, W]``,
    at ``x [N, D]`` (one input for every sample) or ``[S, N, D]`` (one per sample):
    ``[S, N, d_out_last]``."""
    S, N = noise.shape[:2]
    step = _sample_chunk(params, S, N, noise.element_size())
    if step >= S:
        return _propagate(params, x, noise)
    return torch.cat([
        _propagate(params, x if x.ndim == 2 else x[s:s + step], noise[s:s + step])
        for s in range(0, S, step)
    ])


def draw_noise(
    generator: Optional[torch.Generator], params: DGPParams, lead: Tuple[int, ...], N: int,
    like: torch.Tensor,
) -> torch.Tensor:
    """Propagation noise ``[*lead, N, W]`` with the dtype and device of ``like``."""
    return standard_normal(generator, tuple(lead) + (N, params.noise_width), like)


def dgp_propagate_samples(
    generator: Optional[torch.Generator], params: DGPParams, x: torch.Tensor, num_samples: int
) -> torch.Tensor:
    """``num_samples`` paths through the stack at ``x [N, D]``: ``[S, N, d_out_last]``."""
    noise = draw_noise(generator, params, (num_samples,), x.shape[0], x)
    return dgp_propagate_from_noise(params, x, noise)


def _kl(params: DGPParams, like: torch.Tensor) -> torch.Tensor:
    kl = like.new_zeros(())
    for layer in params.layers:
        P, M, _ = layer.q_sqrt.shape
        S = torch.tril(layer.q_sqrt)
        diag = torch.diagonal(S, dim1=-2, dim2=-1)
        kl = kl + 0.5 * (
            torch.sum(torch.square(layer.q_mu))
            + torch.sum(torch.square(S))
            - M * P
            - 2.0 * torch.sum(torch.log(torch.clamp_min(torch.abs(diag), 1e-24)))
        )
    return kl


def dgp_elbo_from_noise(
    params: DGPParams, X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """The doubly-stochastic ELBO of the valid rows with a Gaussian likelihood (its
    variance floored at ``NOISE_FLOOR``), over the ``S`` paths of ``noise [S, C, W]``."""
    m = mask.to(X.dtype)
    f = dgp_propagate_from_noise(params, X, noise)  # [S, C, 1]
    sigma2 = torch.clamp_min(params.noise_variance, NOISE_FLOOR)
    lik = -0.5 * torch.log(2.0 * math.pi * sigma2) - 0.5 * torch.square(Y[None] - f) / sigma2
    return torch.sum(torch.mean(lik, dim=0) * m[:, None]) - _kl(params, X)


def dgp_elbo(
    generator: Optional[torch.Generator], params: DGPParams, X: torch.Tensor, Y: torch.Tensor,
    mask: torch.Tensor, num_samples: int = 8,
) -> torch.Tensor:
    """:func:`dgp_elbo_from_noise` on noise drawn from ``generator``."""
    noise = draw_noise(generator, params, (num_samples,), X.shape[0], X)
    return dgp_elbo_from_noise(params, X, Y, mask, noise)


class DGPTrainingResult(NamedTuple):
    params: DGPParams
    loss: torch.Tensor  # the negative ELBO at the last step
    num_nonfinite: torch.Tensor  # steps whose loss was not finite


def _fit(
    step_noise: Callable[[int], torch.Tensor],
    num_steps: int,
    params: DGPParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask: torch.Tensor,
    learning_rate: float,
) -> DGPTrainingResult:
    """Adam on the negative ELBO, step t on the paths of ``step_noise(t) [S, C, W]``, asked
    for in the order of the steps."""
    leaves = []
    for layer in params.layers:
        k = layer.kernel
        leaves += [torch.log(k.variance), torch.log(k.lengthscales), layer.inducing_points,
                   layer.q_mu, layer.q_sqrt]
    leaves += [torch.log(params.noise_variance), params.mean_constant]
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]

    def to_params() -> DGPParams:
        layers = tuple(
            layer.replace(
                kernel=layer.kernel.replace(variance=torch.exp(leaves[5 * i]),
                                            lengthscales=torch.exp(leaves[5 * i + 1])),
                inducing_points=leaves[5 * i + 2], q_mu=leaves[5 * i + 3],
                q_sqrt=leaves[5 * i + 4],
            )
            for i, layer in enumerate(params.layers)
        )
        return DGPParams(layers, torch.exp(leaves[-2]), leaves[-1])

    static = step_noise(0).clone()  # the step's noise: the graph's input

    def before_step(t: int) -> None:
        static.copy_(step_noise(t))

    def loss_fn() -> torch.Tensor:
        return -dgp_elbo_from_noise(to_params(), X, Y, mask, static)

    loss, nonfinite = adam_minimize(leaves, loss_fn, num_steps, learning_rate, before_step)
    with torch.no_grad():
        leaves = [t.detach() for t in leaves]
        return DGPTrainingResult(to_params(), loss, nonfinite)


def fit_dgp_from_noise(
    noise: torch.Tensor,
    params: DGPParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask: torch.Tensor,
    learning_rate: float = 0.01,
) -> DGPTrainingResult:
    """Adam on the negative ELBO, step t on the paths of ``noise[t]`` (``noise [T, S, C,
    W]``): every parameter trains, the kernels' variances and lengthscales and the noise
    variance in log space. ``params`` is not changed."""
    return _fit(noise.__getitem__, noise.shape[0], params, X, Y, mask, learning_rate)


def fit_dgp(
    generator: Optional[torch.Generator],
    params: DGPParams,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask: torch.Tensor,
    num_steps: int = 2000,
    learning_rate: float = 0.01,
    num_samples: int = 8,
) -> DGPTrainingResult:
    """:func:`fit_dgp_from_noise` on fresh noise for every step, drawn from ``generator`` in
    blocks of steps under :data:`FIT_NOISE_BLOCK_BYTES`."""
    step_bytes = num_samples * X.shape[0] * params.noise_width * X.element_size()
    block = max(1, min(num_steps, FIT_NOISE_BLOCK_BYTES // step_bytes))
    drawn = {}  # the block in hand, by its number

    def step_noise(t: int) -> torch.Tensor:
        if t // block not in drawn:
            drawn.clear()  # frees the spent block before the next is drawn
            start = t - t % block
            drawn[t // block] = draw_noise(
                generator, params, (min(block, num_steps - start), num_samples), X.shape[0], X
            )
        return drawn[t // block][t % block]

    return _fit(step_noise, num_steps, params, X, Y, mask, learning_rate)


class DeepGaussianProcess:
    """A deep GP. Implements ``TrainableProbabilisticModel``, ``SupportsPredictY``,
    ``SupportsGetObservationNoise``, ``SupportsGetInternalData``, ``HasTrajectorySampler``
    and ``HasReparamSampler`` (the marginal sampler). Predictions are the moments of
    ``num_predict_samples`` paths drawn at every call from a generator seeded
    :data:`PREDICT_SEED`; ``optimize`` draws each fit's noise from the model's generator."""

    def __init__(
        self,
        params: DGPParams,
        dataset: Dataset,
        *,
        num_train_steps: int = 2000,
        learning_rate: float = 0.01,
        num_predict_samples: int = 64,
        optimize_generator: Optional[torch.Generator] = None,
    ):
        self._params = params
        self._dataset = dataset
        self._num_train_steps = num_train_steps
        self._learning_rate = learning_rate
        self._num_predict_samples = num_predict_samples
        if optimize_generator is None:
            optimize_generator = torch.Generator(device=dataset.device).manual_seed(0)
        self._generator = optimize_generator

    @property
    def params(self) -> DGPParams:
        return self._params

    def get_internal_data(self) -> Dataset:
        return self._dataset

    def get_observation_noise(self) -> torch.Tensor:
        return self._params.noise_variance

    def predict(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The mean and the population variance (floored at 1e-12) of the paths at
        ``query_points [..., D]``: two ``[..., 1]``."""
        flat, unflatten = flatten_leading_dims(query_points)
        generator = torch.Generator(device=flat.device).manual_seed(PREDICT_SEED)
        noise = draw_noise(generator, self._params, (self._num_predict_samples,), flat.shape[0], flat)
        f = dgp_propagate_from_noise(self._params, flat, noise)  # [S, N, 1]
        mean = torch.mean(f, dim=0)
        var = torch.clamp_min(torch.var(f, dim=0, correction=0), 1e-12)
        return unflatten(mean), unflatten(var)

    def predict_y(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, var = self.predict(query_points)
        return mean, var + self._params.noise_variance

    def sample(
        self, generator: Optional[torch.Generator], query_points: torch.Tensor, num_samples: int
    ) -> torch.Tensor:
        """``num_samples`` paths at ``query_points [N, D]``: ``[S, N, 1]``."""
        return dgp_propagate_samples(generator, self._params, query_points, num_samples)

    def update(self, dataset: Dataset) -> None:
        self._dataset = dataset

    def optimize(self, dataset: Dataset) -> DGPTrainingResult:
        result = fit_dgp(
            self._generator, self._params, dataset.query_points, dataset.observations,
            dataset.mask, num_steps=self._num_train_steps, learning_rate=self._learning_rate,
        )
        self._params = result.params
        self._dataset = dataset
        return result

    def trajectory_sampler(self) -> TrajectorySampler:
        return _DGPTrajectorySampler(self)

    def reparam_sampler(self, num_samples: int) -> ReparametrizationSampler:
        from ..gp.sampler import IndependentReparametrizationSampler

        return IndependentReparametrizationSampler(num_samples, self)

    def log(self, dataset: Optional[Dataset] = None) -> None:
        """Nothing is logged, as in the JAX package."""

    def __repr__(self) -> str:
        return f"DeepGaussianProcess(L={len(self._params.layers)})"


def dgp_trajectory_from_noise(
    params: DGPParams, x: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """Column b of ``x [N, B, D]`` along the path of ``noise[b]`` (``noise [B, N, W]``):
    ``[N, B, d_out_last]``."""
    return dgp_propagate_from_noise(params, x.transpose(0, 1), noise).transpose(0, 1)


class _DGPTrajectory(TrajectoryFunctionClass):
    """Independent paths through the stack, one per batch column, each with noise frozen
    by ``seed``: every call draws it anew from a generator seeded ``seed``, as the JAX
    package draws it from fixed keys, so a column's noise depends on its row and on ``N``."""

    def __init__(self, params: DGPParams, seed: int):
        self.params = params
        self.seed = seed

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        N, B = x.shape[:2]
        generator = torch.Generator(device=x.device).manual_seed(self.seed)
        return dgp_trajectory_from_noise(
            self.params, x, draw_noise(generator, self.params, (B,), N, x)
        )


class _DGPTrajectorySampler(TrajectorySampler):
    def __init__(self, model: DeepGaussianProcess):
        super().__init__(model)

    def get_trajectory(
        self, generator: Optional[torch.Generator], batch_size: int = 1
    ) -> TrajectoryFunction:
        model: DeepGaussianProcess = self._model
        generator = generator_for(generator, model.get_internal_data().device)
        seed = int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))
        return _DGPTrajectory(model.params, seed)


def build_vanilla_deep_gp(
    dataset: Dataset,
    search_space,
    *,
    num_layers: int = 2,
    num_inducing_points: Optional[int] = None,
    inner_layer_width: Optional[int] = None,
    likelihood_variance: float = 1e-2,
    num_train_steps: int = 2000,
    learning_rate: float = 0.01,
    generator: Optional[torch.Generator] = None,
) -> DeepGaussianProcess:
    """A vanilla deep GP on the dataset's device and dtype: inner layers at
    ``inner_layer_width`` (default: the input's) with an identity mean, a scalar output
    layer; ``min(20·D, 100)`` inducing points (default) placed by k-means, in every layer.
    ``generator`` (default: seeded 0 on the dataset's device) draws the k-means start and
    then each fit's noise."""
    if num_layers < 1:
        raise ValueError(f"num_layers must be at least 1, got {num_layers}")
    from ..gp.inducing_points import KMeansInducingPointSelector

    D, dtype, device = dataset.dimension, dataset.query_points.dtype, dataset.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    M = num_inducing_points or min(20 * D, 100)
    width = inner_layer_width or D
    Z0 = KMeansInducingPointSelector(generator=generator)._recalculate_inducing_points(
        M, None, dataset
    )
    extent = (search_space.upper - search_space.lower).to(dtype)
    eye = torch.eye(M, dtype=dtype, device=device)
    layers = []
    d_in = D
    for i in range(num_layers):
        inner = i < num_layers - 1
        d_out = width if inner else 1
        if i == 0 or d_in <= D:
            Z = Z0[:, :d_in]
        else:
            Z = torch.cat([Z0, Z0.new_zeros((M, d_in - D))], dim=-1)
        ls = 0.5 * torch.ones(d_in, dtype=dtype, device=device) * (torch.mean(extent) if i == 0 else 1.0)
        layers.append(DGPLayerParams(
            kernel=stationary("rbf", 0.6 if inner else 1.0, ls, dtype=dtype, device=device),
            inducing_points=Z,
            q_mu=torch.zeros((M, d_out), dtype=dtype, device=device),
            q_sqrt=((1e-1 if inner else 1.0) * eye).expand(d_out, M, M).clone(),
        ))
        d_in = d_out
    y = dataset.trimmed_observations
    params = DGPParams(
        layers=tuple(layers),
        noise_variance=torch.tensor(likelihood_variance, dtype=dtype, device=device),
        mean_constant=torch.mean(y) if y.shape[0] else torch.zeros((), dtype=dtype, device=device),
    )
    return DeepGaussianProcess(params, dataset, num_train_steps=num_train_steps,
                               learning_rate=learning_rate, optimize_generator=generator)
