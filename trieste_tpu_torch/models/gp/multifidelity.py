"""Multifidelity GP models (counterpart of :mod:`trieste_tpu.models.gp.multifidelity`).

* :class:`MultifidelityAutoregressive`: the Kennedy-O'Hagan AR(1) model,
  ``f_i(x) = rho_{i-1} f_{i-1}(x) + delta_i(x)``, one exact GPR per level on the residuals
  and a scalar ``rho`` between levels.
* :class:`MultifidelityNonlinearAutoregressive`: NARGP, where level ``i`` regresses on
  ``[x, f_{i-1}(x)]`` and predictions carry Monte-Carlo samples up through the levels.

Query points carry a trailing fidelity column. ``predict`` and
``covariance_with_top_fidelity`` check it (non-negative integers up to the top fidelity,
one read from the device per call); their ``*_unchecked`` twins, which MUMBO's functions
call on every evaluation, do not. Every level is an exact GPR, so a large pool reaches the
fused prediction kernel once per level; NARGP's upper levels see the ``S_mc`` samples of
every row as one pool of ``S_mc·N`` rows.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ...data import (
    Dataset,
    check_and_extract_fidelity_query_points,
    split_dataset_by_fidelity,
)
from ...ops.lbfgs import minimize_lbfgs
from ...utils.misc import flatten_leading_dims, new_generator, standard_normal
from .gpr import GaussianProcessRegression
from .posterior import log_marginal_likelihood
from .training import randomize_starts, unpack_params

RHO_STARTS = (0.5, 1.0, 2.0)
"""AR(1) fits each ``rho`` from its current value (three starts) and from these."""


def _select_by_fidelity(
    values_per_level: Sequence[torch.Tensor], fidelities: torch.Tensor
) -> torch.Tensor:
    """Each row's value at its own (integer) fidelity: ``S × [N, P]`` and ``[N, 1]`` to
    ``[N, P]``."""
    stacked = torch.stack(list(values_per_level))  # [S, N, P]
    idx = fidelities[:, 0].long()
    return torch.gather(stacked, 0, idx[None, :, None].expand(1, -1, stacked.shape[-1]))[0]


class _MultifidelityModel:
    """What the two models share: the fidelity column, the selection and the samples."""

    _models: List[GaussianProcessRegression]
    _dataset: Optional[Dataset] = None

    @property
    def num_fidelities(self) -> int:
        return len(self._models)

    def _split(self, query_points: torch.Tensor, check: bool):
        flat, unflatten = flatten_leading_dims(query_points, output_dims=2)
        if check:
            x, fid = check_and_extract_fidelity_query_points(
                flat, max_fidelity=self.num_fidelities - 1
            )
        else:
            x, fid = flat[:, :-1], flat[:, -1:]
        return x, fid, unflatten

    def _moments(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        raise NotImplementedError

    def _covariances(self, x: torch.Tensor) -> List[torch.Tensor]:
        raise NotImplementedError

    def _predict(self, query_points: torch.Tensor, check: bool):
        x, fid, unflatten = self._split(query_points, check)
        means, variances = self._moments(x)
        return unflatten(_select_by_fidelity(means, fid)), unflatten(
            _select_by_fidelity(variances, fid)
        )

    def predict(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[..., D+1]`` (a trailing fidelity column) → each row's level mean and variance."""
        return self._predict(query_points, check=True)

    def predict_unchecked(self, query_points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`predict` without the check of the fidelity column."""
        return self._predict(query_points, check=False)

    def _covariance(self, query_points: torch.Tensor, check: bool) -> torch.Tensor:
        x, fid, unflatten = self._split(query_points, check)
        return unflatten(_select_by_fidelity(self._covariances(x), fid))

    def covariance_with_top_fidelity(self, query_points: torch.Tensor) -> torch.Tensor:
        """``cov(f_m(x), f_top(x))`` at each ``[x, m]`` row."""
        return self._covariance(query_points, check=True)

    def covariance_with_top_fidelity_unchecked(self, query_points: torch.Tensor) -> torch.Tensor:
        return self._covariance(query_points, check=False)

    def sample(
        self, generator: Optional[torch.Generator], query_points: torch.Tensor, num_samples: int
    ) -> torch.Tensor:
        """Independent samples of each row's marginal, ``[S, ..., 1]``."""
        mean, var = self.predict(query_points)
        eps = standard_normal(generator, (num_samples,) + tuple(mean.shape), mean)
        return mean[None] + torch.sqrt(var)[None] * eps

    def update(self, dataset: Dataset) -> None:
        """Keep the data; the levels are split and refitted in :meth:`optimize`."""
        self._dataset = dataset

    def log(self, dataset: Optional[Dataset] = None) -> None:
        """Nothing is logged, as in the JAX package."""


class MultifidelityAutoregressive(_MultifidelityModel):
    """The AR(1) multifidelity model."""

    def __init__(
        self,
        fidelity_models: Sequence[GaussianProcessRegression],
        rho: Optional[torch.Tensor] = None,
    ):
        self._models = list(fidelity_models)
        S = len(self._models)
        if S < 2:
            raise ValueError(f"multifidelity models need >= 2 fidelities, got {S}")
        like = self._models[0].params.kernel.variance
        self.rho = (
            torch.ones(S - 1, dtype=like.dtype, device=like.device) if rho is None
            else torch.as_tensor(rho, dtype=like.dtype, device=like.device)
        )

    @property
    def lowest_fidelity_signal_model(self) -> GaussianProcessRegression:
        return self._models[0]

    @property
    def fidelity_residual_models(self) -> Sequence[GaussianProcessRegression]:
        return self._models[1:]

    def _moments(
        self, x: torch.Tensor, top: Optional[int] = None
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Mean and variance of the levels up to ``top`` (default: all) at ``x [N, D]``."""
        top = self.num_fidelities - 1 if top is None else top
        m, v = self._models[0].predict(x)
        means, variances = [m], [v]
        for i, model in enumerate(self._models[1 : top + 1]):
            dm, dv = model.predict(x)
            means.append(self.rho[i] * means[-1] + dm)
            variances.append(self.rho[i] ** 2 * variances[-1] + dv)
        return means, variances

    def _covariances(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Under AR(1), ``cov(f_m, f_top) = Π_{j ≥ m} rho_j · var(f_m)``."""
        _, variances = self._moments(x)
        S = self.num_fidelities
        return [
            (torch.prod(self.rho[m:]) if m < S - 1 else 1.0) * variances[m] for m in range(S)
        ]

    def optimize(self, dataset: Dataset) -> None:
        """Fit level 0 on its data; then, level by level, fit ``rho`` jointly with the
        residual GP's hyperparameters by maximum likelihood, one lockstep L-BFGS from six
        starts (``rho`` at its current value three times and at :data:`RHO_STARTS`, the GP
        parameters from :func:`randomize_starts` with a generator seeded by the level); the
        residual data is ``obs − rho · mean of the level below``. Within the loop the
        levels below predict with the ``rho`` the model had when the fit began."""
        self._dataset = dataset
        per_level = split_dataset_by_fidelity(dataset, self.num_fidelities)
        m0 = self._models[0]
        m0.update(per_level[0])
        m0.optimize(per_level[0])
        rho = self.rho.tolist()
        for i, model in enumerate(self._models[1:]):
            level = i + 1
            qp, obs = per_level[level].astuple()
            prev_mean = self._moments(qp, level - 1)[0][level - 1]
            padded = Dataset.from_arrays(qp, obs)
            prev_mean_padded = padded.observations.new_zeros((padded.capacity, 1))
            prev_mean_padded[: qp.shape[0]] = prev_mean
            template, train_noise = model.params, model._train_noise

            def loss_fn(u: torch.Tensor, template=template, train_noise=train_noise,
                        padded=padded, prev=prev_mean_padded) -> torch.Tensor:  # [R, n] -> [R]
                gp_params = unpack_params(u[:, 1:], template, train_noise)
                resid = padded.observations - u[:, 0, None, None] * prev
                return -log_marginal_likelihood(
                    gp_params, padded.query_points, resid, padded.mask
                )

            generator = torch.Generator(device=qp.device).manual_seed(level)
            gp_starts = randomize_starts(generator, template, 3 + len(RHO_STARTS), train_noise)
            rho_starts = torch.tensor(
                [[rho[i]]] * 3 + [[r] for r in RHO_STARTS], dtype=qp.dtype, device=qp.device
            )
            results = minimize_lbfgs(loss_fn, torch.cat([rho_starts, gp_starts], dim=-1),
                                     max_iters=100)
            losses = torch.where(torch.isfinite(results.fun), results.fun, torch.inf)
            best_u = results.x[torch.argmin(losses)].detach()
            rho[i] = float(best_u[0])
            model._params = unpack_params(best_u[1:], template, train_noise)
            model.update(Dataset.from_arrays(qp, obs - rho[i] * prev_mean))
        self.rho = torch.tensor(rho, dtype=self.rho.dtype, device=self.rho.device)

    def __repr__(self) -> str:
        return f"MultifidelityAutoregressive(S={self.num_fidelities}, rho={self.rho})"


class MultifidelityNonlinearAutoregressive(_MultifidelityModel):
    """NARGP: level 0 is a GPR over ``x``, level ``i ≥ 1`` a GPR over ``[x, f_{i-1}(x)]``.
    A prediction draws ``num_monte_carlo`` samples of each level at every row, carries
    them up as the next level's inputs, and reports the mixture's moments. Every call
    draws new samples from the model's generator (``None``: one seeded 0 on the data's
    device, made at the first call)."""

    def __init__(
        self,
        fidelity_models: Sequence[GaussianProcessRegression],
        num_monte_carlo: int = 32,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        self._models = list(fidelity_models)
        if len(self._models) < 2:
            raise ValueError("need >= 2 fidelities")
        self._num_mc = num_monte_carlo
        self._generator = generator

    def _level_samples(
        self, x: torch.Tensor
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
        """The levels' mixture means and variances at ``x [N, D]`` and their propagated
        samples ``[S_mc, N, 1]``. Each upper level predicts its ``S_mc·N`` rows at once."""
        m0, v0 = self._models[0].predict(x)
        if self._generator is None:
            self._generator = new_generator(x.device, 0)
        eps = standard_normal(
            self._generator, (self.num_fidelities, self._num_mc) + tuple(m0.shape), m0
        )
        means, variances = [m0], [v0]
        samples = [m0[None] + torch.sqrt(v0)[None] * eps[0]]
        S_mc, (N, D) = self._num_mc, x.shape
        for i, model in enumerate(self._models[1:]):
            aug = torch.cat([x.expand(S_mc, N, D), samples[-1]], dim=-1)
            ms, vs = model.predict(aug.reshape(S_mc * N, D + 1))
            ms, vs = ms.reshape(S_mc, N, -1), vs.reshape(S_mc, N, -1)
            mean_i = torch.mean(ms, dim=0)
            var_i = torch.mean(vs + torch.square(ms), dim=0) - torch.square(mean_i)
            means.append(mean_i)
            variances.append(torch.clamp_min(var_i, 1e-24))
            samples.append(ms + torch.sqrt(vs) * eps[i + 1])
        return means, variances, samples

    def _moments(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        means, variances, _ = self._level_samples(x)
        return means, variances

    def _covariances(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The Monte-Carlo estimate of ``cov(f_m, f_top)`` from the propagated samples."""
        _, _, samples = self._level_samples(x)
        top = samples[-1]
        return [
            torch.mean(s * top, dim=0) - torch.mean(s, dim=0) * torch.mean(top, dim=0)
            for s in samples
        ]

    def optimize(self, dataset: Dataset) -> None:
        """Fit level 0 on its data, then each level on its data with the input augmented
        by the mean of the chain below."""
        self._dataset = dataset
        per_level = split_dataset_by_fidelity(dataset, self.num_fidelities)
        m0 = self._models[0]
        m0.update(per_level[0])
        m0.optimize(per_level[0])
        for i, model in enumerate(self._models[1:]):
            qp, obs = per_level[i + 1].astuple()
            prev_mean, _ = _chain_mean(self._models[: i + 1], qp)
            aug_ds = Dataset.from_arrays(torch.cat([qp, prev_mean], dim=-1), obs)
            model.update(aug_ds)
            model.optimize(aug_ds)


def _chain_mean(
    models: Sequence[GaussianProcessRegression], x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean carried up a NARGP chain without sampling."""
    m, v = models[0].predict(x)
    for model in models[1:]:
        m, v = model.predict(torch.cat([x, m], dim=-1))
    return m, v


def build_multifidelity_autoregressive_models(
    dataset: Dataset,
    num_fidelities: int,
    input_search_space,
    likelihood_variance: Optional[float] = 1e-6,
    kernel_priors: bool = False,
) -> MultifidelityAutoregressive:
    """An AR(1) model with one :func:`build_gpr` per level, each on its level's data (on
    level 0's where a level has none), at the fixed ``likelihood_variance`` (``None``: the
    builder's default from the data). ``kernel_priors`` is accepted as the JAX package
    accepts it, and read by neither: every level takes the builder's priors."""
    from .builders import build_gpr

    per_level = split_dataset_by_fidelity(dataset, num_fidelities)
    models = [
        build_gpr(
            per_level[i] if len(per_level[i]) > 0 else per_level[0],
            input_search_space,
            likelihood_variance=likelihood_variance,
        )
        for i in range(num_fidelities)
    ]
    return MultifidelityAutoregressive(models)
