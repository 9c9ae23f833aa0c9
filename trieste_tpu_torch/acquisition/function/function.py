"""Improvement-based and confidence-bound acquisition functions (counterpart of
:mod:`trieste_tpu.acquisition.function.function`): probability of improvement, analytic
EI and its augmented, Monte-Carlo and batch forms, the confidence bounds (one optimism
level or a vectorized fleet of them), probability of feasibility, constrained EI and the
softplus wrapper. Minimization convention. Every builder returns a
:func:`functools.partial` of a module-level function bound to the model's prediction and
the builder's state.

A Monte-Carlo builder draws its base normal samples once, when the function is prepared,
and the function closes over them: it is the same surface at every call of a step, which
the optimizer's line search depends on. ``generator=None`` seeds those draws with 0 on the
data's device at every preparation, so the surface is reproducible."""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Mapping, Optional, Sequence

import torch

from ...data import Dataset
from ...models.interfaces import HasReparamSampler, ModelStack, ProbabilisticModel
from ...space import SearchSpace
from ...types import Tag
from ...utils.misc import new_generator
from ..interface import (
    AcquisitionFunction,
    AcquisitionFunctionBuilder,
    SingleModelAcquisitionBuilder,
    SingleModelVectorizedAcquisitionBuilder,
)
from ..utils import joint_predictor, predictor
from .utils import make_mvn_cdf, mvn_cdf

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _validate_dataset(dataset: Optional[Dataset], who: str) -> Dataset:
    if dataset is None or dataset.num_points == 0:
        raise ValueError(f"{who} requires a non-empty dataset")
    return dataset


def _masked_min_mean(mean: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The minimum of ``mean [C, L]`` over the rows that ``keep [C]`` marks."""
    return torch.min(torch.where(keep[:, None], mean, torch.finfo(mean.dtype).max))


def _min_posterior_mean(model: ProbabilisticModel, dataset: Dataset) -> torch.Tensor:
    """eta: the minimum posterior mean over the observed (unpadded) points."""
    mean, _ = model.predict(dataset.query_points)
    return _masked_min_mean(mean, dataset.mask)


def _normal_pdf(z: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * z * z) * _INV_SQRT_2PI


def _std(var: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(var, 1e-24))


def _single_batch(x: torch.Tensor, who: str) -> torch.Tensor:
    """Check that ``x`` is ``[..., 1, D]``: scoring only the first element of a batch
    would be wrong, not slow."""
    if x.ndim < 2 or x.shape[-2] != 1:
        raise ValueError(f"{who} only supports batch sizes of one, got query shape {tuple(x.shape)}")
    return x


def _ei_fn(predict: Callable, eta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Analytic expected improvement, ``x: [..., 1, D] -> [..., 1]``."""
    mean, var = predict(_single_batch(x, "expected_improvement")[..., 0, :])  # [..., L]
    std = _std(var)
    z = (eta - mean) / std
    return ((eta - mean) * torch.special.ndtr(z) + std * _normal_pdf(z))[..., 0:1]


def _poi_fn(predict: Callable, eta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Probability of improvement on ``eta``, ``x: [..., 1, D] -> [..., 1]``."""
    mean, var = predict(_single_batch(x, "probability_of_improvement")[..., 0, :])
    return torch.special.ndtr((eta - mean) / _std(var))[..., 0:1]


def _aei_fn(
    predict: Callable, eta: torch.Tensor, noise_variance: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Augmented EI for noisy observations: EI times ``1 − σ_n / sqrt(σ_n² + var)``."""
    mean, var = predict(_single_batch(x, "augmented_expected_improvement")[..., 0, :])
    std = _std(var)
    z = (eta - mean) / std
    ei = (eta - mean) * torch.special.ndtr(z) + std * _normal_pdf(z)
    augmentation = 1.0 - torch.sqrt(noise_variance) / torch.sqrt(noise_variance + var)
    return (ei * augmentation)[..., 0:1]


def _neg_lcb_fn(predict: Callable, beta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Negative lower confidence bound ``−(mean − beta·std)``, ``[..., 1, D] -> [..., 1]``."""
    mean, var = predict(_single_batch(x, "lower_confidence_bound")[..., 0, :])
    return -(mean - beta * _std(var))[..., 0:1]


def _pof_fn(predict: Callable, threshold: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Probability of feasibility ``P(f(x) < threshold)``."""
    mean, var = predict(_single_batch(x, "probability_of_feasibility")[..., 0, :])
    return torch.special.ndtr((threshold - mean) / _std(var))[..., 0:1]


def _product_fn(fns: Sequence[Callable], x: torch.Tensor) -> torch.Tensor:
    result = fns[0](x)
    for f in fns[1:]:
        result = result * f(x)
    return result


def _make_positive_fn(base: Callable, x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.softplus(base(x))


def _monlcb_fn(predict: Callable, betas: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Negative LCB with one ``beta`` per slice, ``x: [..., V, D] -> [..., V]``."""
    mean, var = predict(x)  # [..., V, L]
    return -(mean - betas[..., :, None] * _std(var))[..., 0]


def _monlcb_fn_spread(predict: Callable, dim: float, x: torch.Tensor) -> torch.Tensor:
    """Per-slice betas by the CDF spread of Torossian et al.: slice v of V takes the
    normal quantile of ``0.5 + 0.5 v/(V+1)`` times ``5·dim``, so slice 1 nearly exploits
    and slice V explores."""
    V = x.shape[-2]
    spread = 0.5 + 0.5 * torch.arange(1, V + 1, dtype=x.dtype, device=x.device) / (V + 1.0)
    return _monlcb_fn(predict, 5.0 * dim * torch.special.ndtri(spread), x)


class ProbabilityOfImprovement(SingleModelAcquisitionBuilder):
    """The probability of improving on the minimum posterior mean at the observed
    points."""

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        dataset = _validate_dataset(dataset, "ProbabilityOfImprovement")
        return partial(_poi_fn, predictor(model), _min_posterior_mean(model, dataset))

    def __repr__(self) -> str:
        return "ProbabilityOfImprovement()"


class ExpectedImprovement(SingleModelAcquisitionBuilder):
    """Analytic EI with the incumbent eta taken as the minimum posterior mean over the
    observed points, or over the feasible ones where ``search_space`` has constraints."""

    def __init__(self, search_space: Optional[SearchSpace] = None):
        self._search_space = search_space

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        dataset = _validate_dataset(dataset, "ExpectedImprovement")
        return partial(_ei_fn, predictor(model), self._eta(model, dataset))

    def _eta(self, model: ProbabilisticModel, dataset: Dataset) -> torch.Tensor:
        space = self._search_space
        if space is not None and getattr(space, "has_constraints", False):
            mean, _ = model.predict(dataset.query_points)
            feasible = space.is_feasible(dataset.query_points) & dataset.mask
            return _masked_min_mean(mean, feasible)
        return _min_posterior_mean(model, dataset)

    def __repr__(self) -> str:
        return "ExpectedImprovement()"


class AugmentedExpectedImprovement(SingleModelAcquisitionBuilder):
    """EI scaled down where the observation noise dominates the posterior variance."""

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        dataset = _validate_dataset(dataset, "AugmentedExpectedImprovement")
        if not hasattr(model, "get_observation_noise"):
            raise NotImplementedError(
                "AugmentedExpectedImprovement requires a model with observation noise"
            )
        return partial(
            _aei_fn, predictor(model), _min_posterior_mean(model, dataset),
            model.get_observation_noise(),
        )

    def __repr__(self) -> str:
        return "AugmentedExpectedImprovement()"


class NegativeLowerConfidenceBound(SingleModelAcquisitionBuilder):
    """``−(mean − beta·std)``: maximizing it minimizes the lower confidence bound."""

    def __init__(self, beta: float = 1.96):
        if beta < 0:
            raise ValueError(f"beta must be non-negative, got {beta}")
        self._beta = beta

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        return partial(_neg_lcb_fn, predictor(model), self._beta)

    def __repr__(self) -> str:
        return f"NegativeLowerConfidenceBound({self._beta!r})"


class NegativePredictiveMean(NegativeLowerConfidenceBound):
    """The negative posterior mean: pure exploitation."""

    def __init__(self) -> None:
        super().__init__(beta=0.0)

    def __repr__(self) -> str:
        return "NegativePredictiveMean()"


class ProbabilityOfFeasibility(SingleModelAcquisitionBuilder):
    """``P(f(x) < threshold)`` under a constraint model."""

    def __init__(self, threshold: float):
        self._threshold = threshold

    @property
    def threshold(self) -> float:
        return self._threshold

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        return partial(_pof_fn, predictor(model), self._threshold)

    def __repr__(self) -> str:
        return f"ProbabilityOfFeasibility({self._threshold!r})"


class ExpectedConstrainedImprovement(AcquisitionFunctionBuilder):
    """EI over the feasible region, ``EI(x | feasible incumbent) · PoF(x)``; while no
    observed point is feasible, the constraint function alone. The objective model and
    data sit under ``objective_tag``; ``constraint_builder`` reads its own tags."""

    def __init__(
        self,
        objective_tag: Tag,
        constraint_builder: AcquisitionFunctionBuilder,
        min_feasibility_probability: float = 0.5,
        search_space: Optional[SearchSpace] = None,
    ):
        if not 0 <= min_feasibility_probability <= 1:
            raise ValueError(
                f"min_feasibility_probability must be in [0, 1], got "
                f"{min_feasibility_probability}"
            )
        self._objective_tag = objective_tag
        self._constraint_builder = constraint_builder
        self._min_feasibility_probability = min_feasibility_probability
        self._search_space = search_space

    def prepare_acquisition_function(
        self,
        models: Mapping[Tag, ProbabilisticModel],
        datasets: Optional[Mapping[Tag, Dataset]] = None,
    ) -> AcquisitionFunction:
        if datasets is None or self._objective_tag not in datasets:
            raise ValueError(
                f"ExpectedConstrainedImprovement requires a dataset for tag "
                f"{self._objective_tag!r}"
            )
        objective_dataset = _validate_dataset(
            datasets[self._objective_tag], "ExpectedConstrainedImprovement"
        )
        objective_model = models[self._objective_tag]
        constraint_fn = self._constraint_builder.prepare_acquisition_function(models, datasets)
        qp = objective_dataset.query_points
        pof = constraint_fn(qp[:, None, :])[..., 0]  # [C]
        is_feasible = (pof >= self._min_feasibility_probability) & objective_dataset.mask
        if not bool(torch.any(is_feasible)):
            return constraint_fn
        mean, _ = objective_model.predict(qp)
        ei = partial(_ei_fn, predictor(objective_model), _masked_min_mean(mean, is_feasible))
        return partial(_product_fn, (ei, constraint_fn))

    def __repr__(self) -> str:
        return (
            f"ExpectedConstrainedImprovement({self._objective_tag!r}, "
            f"{self._constraint_builder!r}, {self._min_feasibility_probability!r})"
        )


class MakePositive(SingleModelAcquisitionBuilder):
    """Softplus of another acquisition, for callers that assume positive values (the
    base of :class:`~.greedy_batch.LocalPenalization`)."""

    def __init__(self, base_builder: SingleModelAcquisitionBuilder):
        self._base = base_builder
        self._base_fn: Optional[AcquisitionFunction] = None

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        self._base_fn = self._base.prepare_acquisition_function(model, dataset)
        return partial(_make_positive_fn, self._base_fn)

    def update_acquisition_function(
        self,
        function: AcquisitionFunction,
        model: ProbabilisticModel,
        dataset: Optional[Dataset] = None,
    ) -> AcquisitionFunction:
        if self._base_fn is None:
            return self.prepare_acquisition_function(model, dataset)
        self._base_fn = self._base.update_acquisition_function(self._base_fn, model, dataset)
        return partial(_make_positive_fn, self._base_fn)

    def __repr__(self) -> str:
        return f"MakePositive({self._base!r})"


class MultipleOptimismNegativeLowerConfidenceBound(SingleModelVectorizedAcquisitionBuilder):
    """A vectorized fleet of negative LCBs (MONLCB), one optimism level per slice of a
    ``[..., V, D]`` query (see :func:`_monlcb_fn_spread`); the betas scale with the
    search space's dimension."""

    def __init__(self, search_space: SearchSpace):
        self._dim = float(search_space.dimension)

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        return partial(_monlcb_fn_spread, predictor(model), self._dim)

    def __repr__(self) -> str:
        return "MultipleOptimismNegativeLowerConfidenceBound()"


def _mc_ei_fn(sample: Callable, eta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Monte-Carlo EI from frozen reparametrization samples, ``x: [..., 1, D] -> [..., 1]``."""
    samples = sample(_single_batch(x, "monte_carlo_expected_improvement"))  # [..., S, 1, L]
    improvement = torch.clamp_min(eta - samples[..., 0, :], 0.0)  # [..., S, L]
    return torch.mean(improvement, dim=-2)[..., 0:1]


def _mc_aei_fn(
    sample: Callable, predict: Callable, eta: torch.Tensor, noise_variance: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """Monte-Carlo augmented EI: MC EI times the noise augmentation factor."""
    ei = _mc_ei_fn(sample, eta, x)
    _, var = predict(x[..., 0, :])
    augmentation = 1.0 - torch.sqrt(noise_variance) / torch.sqrt(noise_variance + var)
    return ei * augmentation[..., 0:1]


def _batch_mc_ei_fn(sample: Callable, eta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batch Monte-Carlo (q)EI, ``x: [..., B, D] -> [..., 1]``."""
    samples = sample(x)  # [..., S, B, L]
    min_over_batch = torch.min(samples[..., 0], dim=-1).values  # [..., S]
    improvement = torch.clamp_min(eta - min_over_batch, 0.0)
    return torch.mean(improvement, dim=-1, keepdim=True)


class _MonteCarloBuilder(SingleModelAcquisitionBuilder):
    def __init__(self, sample_size: int, *, generator: Optional[torch.Generator] = None):
        if sample_size <= 0:
            raise ValueError(f"sample_size must be positive, got {sample_size}")
        self._sample_size = sample_size
        self._generator = generator

    def _sample_fn(
        self, model: ProbabilisticModel, dataset: Dataset, joint: bool, **sample_args
    ) -> Callable[[torch.Tensor], torch.Tensor]:
        """A sampling callable for ``model`` whose base draws freeze at its first call:
        the model's own reparametrization sampler for joint samples over a batch (a model
        stack's members' samplers side by side), the independent sampler for marginal
        ones."""
        from ...models.gp.sampler import IndependentReparametrizationSampler
        from ...models.stacks import StackReparametrizationSampler

        if not joint:
            sampler = IndependentReparametrizationSampler(self._sample_size, model)
        elif isinstance(model, HasReparamSampler):
            sampler = model.reparam_sampler(self._sample_size)
        elif isinstance(model, ModelStack):
            sampler = StackReparametrizationSampler(self._sample_size, model)
        else:
            raise ValueError(
                "Monte-Carlo batch acquisition functions require a model with a "
                f"reparam_sampler method; received {model!r}"
            )
        generator = self._generator or new_generator(dataset.device, 0)
        return partial(sampler.sample, generator=generator, **sample_args)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._sample_size!r})"


class MonteCarloExpectedImprovement(_MonteCarloBuilder):
    """MC EI over marginal reparametrization samples."""

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        dataset = _validate_dataset(dataset, "MonteCarloExpectedImprovement")
        sample = self._sample_fn(model, dataset, joint=False)
        return partial(_mc_ei_fn, sample, _min_posterior_mean(model, dataset))


class MonteCarloAugmentedExpectedImprovement(_MonteCarloBuilder):
    """MC augmented EI for noisy problems."""

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        dataset = _validate_dataset(dataset, "MonteCarloAugmentedExpectedImprovement")
        if not hasattr(model, "get_observation_noise"):
            raise NotImplementedError(
                "MonteCarloAugmentedExpectedImprovement requires observation noise"
            )
        sample = self._sample_fn(model, dataset, joint=False)
        return partial(
            _mc_aei_fn, sample, predictor(model), _min_posterior_mean(model, dataset),
            model.get_observation_noise(),
        )


class BatchMonteCarloExpectedImprovement(_MonteCarloBuilder):
    """Reparametrization-trick qEI over joint batch samples. ``jitter`` goes on the
    batch covariance before its Cholesky (default: the dtype's jitter)."""

    def __init__(
        self,
        sample_size: int,
        *,
        jitter: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(sample_size, generator=generator)
        self._jitter = jitter

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        dataset = _validate_dataset(dataset, "BatchMonteCarloExpectedImprovement")
        sample = self._sample_fn(model, dataset, joint=True, jitter=self._jitter)
        return partial(_batch_mc_ei_fn, sample, _min_posterior_mean(model, dataset))


def _analytic_qei_fn(
    predict_joint: Callable, eta: torch.Tensor, qmc_points: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Analytic batch EI by the Chevalier-Ginsbourger decomposition with Genz MVN CDFs.

    ``qEI = sum_k E[(eta - Y_k) 1{Y_k <= eta, Y_k = min Y}]``; each term is an affine
    transform of the joint posterior evaluated through Q- and (Q-1)-dimensional normal
    CDFs. ``x: [..., B, D] -> [..., 1]``.
    """
    mean, cov = predict_joint(x)  # [..., B, L], [..., L, B, B]
    m = mean[..., 0]  # [..., B]
    S = cov[..., 0, :, :]  # [..., B, B]
    Q = m.shape[-1]
    dtype, device = m.dtype, m.device
    if qmc_points.shape[-1] < max(Q - 1, 1):
        # the QMC set is sized for moderate batches; a larger batch gets its own
        qmc_points = make_mvn_cdf(qmc_points.shape[0], Q, dtype=dtype, device=device)
    eye = torch.eye(Q, dtype=dtype, device=device)
    total = torch.zeros(m.shape[:-1], dtype=dtype, device=device)
    for k in range(Q):
        # A: rows j != k give Y_k - Y_j; row k gives Y_k
        A = -eye.clone()
        A[:, k] += 1.0
        A[k, k] = 1.0
        mk = torch.einsum("ij,...j->...i", A, m)
        Sk = torch.einsum("ij,...jl,ml->...im", A, S, A) + 1e-10 * eye
        bk = (eye[k] * eta).expand(mk.shape)  # zeros except eta at k
        term = (eta - mk[..., k]) * mvn_cdf(bk, mk, Sk, qmc_points)
        # second-order terms: sum_i Sk[k, i] * phi_1(b_i) * Phi_{Q-1}(conditional)
        for i in range(Q):
            Sii = torch.clamp_min(Sk[..., i, i], 1e-24)
            std_i = torch.sqrt(Sii)
            z_i = (bk[..., i] - mk[..., i]) / std_i
            phi_i = torch.exp(-0.5 * z_i**2) / (std_i * math.sqrt(2.0 * math.pi))
            if Q == 1:
                cond_cdf = torch.ones_like(total)
            else:
                rest = [j for j in range(Q) if j != i]
                S_ri = Sk[..., rest, i]  # [..., Q-1]
                S_rr = Sk[..., rest, :][..., :, rest]
                mu_cond = mk[..., rest] + S_ri * ((bk[..., i] - mk[..., i]) / Sii)[..., None]
                S_cond = S_rr - S_ri[..., :, None] * S_ri[..., None, :] / Sii[..., None, None]
                S_cond = S_cond + 1e-10 * eye[: Q - 1, : Q - 1]
                cond_cdf = mvn_cdf(
                    bk[..., rest], mu_cond, S_cond, qmc_points[:, : max(Q - 2, 1)]
                )
            term = term + Sk[..., k, i] * phi_i * cond_cdf
        total = total + term
    return torch.clamp_min(total, 0.0)[..., None]


class BatchExpectedImprovement(SingleModelAcquisitionBuilder):
    """Analytic (accurate but expensive) batch expected improvement."""

    def __init__(self, sample_size: int = 128):
        if sample_size <= 0:
            raise ValueError(f"sample_size must be positive, got {sample_size}")
        self._sample_size = sample_size

    def prepare_acquisition_function(
        self, model: ProbabilisticModel, dataset: Optional[Dataset] = None
    ) -> AcquisitionFunction:
        dataset = _validate_dataset(dataset, "BatchExpectedImprovement")
        eta = _min_posterior_mean(model, dataset)
        # QMC points for the largest CDF dimension expected; each call slices what its
        # batch size needs
        qmc = make_mvn_cdf(self._sample_size, dimension=16, dtype=eta.dtype, device=eta.device)
        return partial(_analytic_qei_fn, joint_predictor(model), eta, qmc)

    def __repr__(self) -> str:
        return f"BatchExpectedImprovement({self._sample_size!r})"
