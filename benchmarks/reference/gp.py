"""Plain exact-GP regression for the benchmark's comparison, written from the textbook
formulas (Rasmussen and Williams, ch. 2 and 5) and not from the program.

The model is the one ``build_gpr`` states: a Matérn-5/2 ARD kernel with signal variance
``s``, lengthscales ``l`` and a constant mean ``m``, a Gaussian likelihood of fixed
variance ``noise``, and a Cholesky jitter on the training covariance. The MAP
objective adds LogNormal priors on ``s`` and ``l`` (densities in the parameters' own
space, constants dropped). Everything runs in the precision it is given
(:mod:`benchmarks.reference.precision`): float64 for the reference, TF32 for the control.

Only ``torch`` is imported: nothing of the program under test.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from benchmarks.reference.precision import FP64, TF32, Precision, matmul, tf32_round

SQRT5 = math.sqrt(5.0)
MATERN52_DF = 5  # degrees of freedom of the Matérn-5/2 spectral density (a Student t)
ROW_BLOCK = 8192  # rows of query points per block: [8192, 1024] float64 is 64 MiB
TRAJECTORY_BLOCK = 2**23  # elements of the features [rows, V, m] per block: 64 MiB


@dataclass(frozen=True)
class Hyper:
    """Hyperparameters of one GP: ``variance`` and ``mean`` scalars, ``lengthscales [D]``,
    the fixed ``noise`` and the Cholesky ``jitter``."""

    variance: torch.Tensor
    lengthscales: torch.Tensor
    mean: torch.Tensor
    noise: float
    jitter: float

    def to(self, prec: Precision) -> "Hyper":
        cast = lambda t: t.to(prec.dtype)  # noqa: E731
        return Hyper(cast(self.variance), cast(self.lengthscales), cast(self.mean),
                     self.noise, self.jitter)


def sqdist(a: torch.Tensor, b: torch.Tensor, lengthscales: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    """``[..., N, M]`` squared distances of ``a/l`` and ``b/l``, by the usual expansion
    ``|a|² + |b|² − 2 a·b``."""
    a = a / lengthscales
    b = b / lengthscales
    ab = matmul(a, b.transpose(-1, -2), prec)
    r2 = (a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :] - 2.0 * ab
    return torch.clamp_min(r2, 0.0)


def matern52(r2: torch.Tensor) -> torch.Tensor:
    r = torch.sqrt(torch.clamp_min(r2, 1e-36))
    z = SQRT5 * r
    return (1.0 + z + z * z / 3.0) * torch.exp(-z)


def kernel(a: torch.Tensor, b: torch.Tensor, h: Hyper, prec: Precision) -> torch.Tensor:
    return h.variance * matern52(sqdist(a, b, h.lengthscales, prec))


JITTER_TRIES = 8


def _train_cholesky(X: torch.Tensor, h: Hyper, prec: Precision) -> torch.Tensor:
    """The Cholesky factor of ``K + (noise + jitter)·I``. In TF32 the rounded Gram can
    lose positive definiteness at a thousand points; there the jitter grows tenfold until
    the factor exists, as a TF32 program would have to, so that the control gives an
    answer instead of none."""
    K = kernel(X, X, h, prec)
    eye = torch.eye(X.shape[0], dtype=K.dtype, device=K.device)
    if not prec.tf32:
        return torch.linalg.cholesky(K + (h.noise + h.jitter) * eye)
    jitter = h.jitter
    for _ in range(JITTER_TRIES):
        L, info = torch.linalg.cholesky_ex(K + (h.noise + jitter) * eye)
        if int(info) == 0:
            return L
        jitter *= 10.0
    raise torch.linalg.LinAlgError(f"no Cholesky factor in TF32 up to jitter {jitter:g}")


def neg_log_marginal_likelihood(X: torch.Tensor, Y: torch.Tensor, h: Hyper,
                                prec: Precision) -> torch.Tensor:
    """``−log p(Y | X)`` of the ``n`` rows of ``X [n, D]``, ``Y [n, 1]``."""
    L = _train_cholesky(X, h, prec)
    ym = Y - h.mean
    alpha = torch.cholesky_solve(ym, L)
    n = X.shape[0]
    return 0.5 * ((ym * alpha).sum() + 2.0 * torch.log(torch.diagonal(L)).sum()
                  + n * math.log(2.0 * math.pi))


@dataclass(frozen=True)
class Priors:
    """LogNormal priors: logs of the prior medians and the shared scale."""

    var_loc: float
    ls_loc: torch.Tensor  # [D]
    scale: float
    squeeze: float  # fitted log-parameters are clipped to loc ± squeeze


def neg_log_prior(h: Hyper, priors: Priors) -> torch.Tensor:
    """``−Σ log LogNormal(x; loc, scale)`` over the signal variance and the lengthscales,
    constants dropped."""
    def term(x: torch.Tensor, loc) -> torch.Tensor:
        lx = torch.log(x)
        loc = torch.as_tensor(loc, dtype=lx.dtype, device=lx.device)
        return lx + 0.5 * torch.square((lx - loc) / priors.scale)

    return term(h.variance, priors.var_loc) + term(h.lengthscales, priors.ls_loc).sum()


def pack(h: Hyper) -> torch.Tensor:
    """The unconstrained vector the fit moves: ``[log s, log l..., m]``."""
    return torch.cat([torch.log(h.variance)[None], torch.log(h.lengthscales), h.mean[None]])


def unpack(u: torch.Tensor, h: Hyper) -> Hyper:
    D = h.lengthscales.shape[0]
    return Hyper(torch.exp(u[0]), torch.exp(u[1:1 + D]), u[1 + D], h.noise, h.jitter)


def box(priors: Priors, dtype: torch.dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The window of the packed vector after the fit: ``loc ± squeeze`` on the kernel's
    log-parameters, none on the mean."""
    loc = torch.cat([torch.tensor([priors.var_loc], dtype=dtype, device=device),
                     priors.ls_loc.to(dtype=dtype, device=device)])
    inf = torch.tensor([math.inf], dtype=dtype, device=device)
    return torch.cat([loc - priors.squeeze, -inf]), torch.cat([loc + priors.squeeze, inf])


def neg_log_posterior(u: torch.Tensor, X, Y, h: Hyper, priors: Priors,
                      prec: Precision) -> torch.Tensor:
    """The MAP objective at the packed vector ``u``, projected into :func:`box` first (the
    window the fit's result is clipped to), so that it is finite everywhere."""
    lo, hi = box(priors, u.dtype, u.device)
    hu = unpack(torch.minimum(torch.maximum(u, lo), hi), h)
    return neg_log_marginal_likelihood(X, Y, hu, prec) + neg_log_prior(hu, priors)


def fit_local(u0: torch.Tensor, X, Y, h: Hyper, priors: Priors, prec: Precision,
              max_iters: int = 100) -> torch.Tensor:
    """A MAP fit from ``u0`` by ``torch.optim.LBFGS`` in ``prec``, its result clipped to
    :func:`box`: where a fit in that precision ends from there."""
    Xp, Yp, hp = X.to(prec.dtype), Y.to(prec.dtype), h.to(prec)
    u = u0.detach().to(prec.dtype).clone().requires_grad_(True)
    opt = torch.optim.LBFGS([u], max_iter=max_iters, line_search_fn="strong_wolfe",
                            tolerance_grad=1e-12, tolerance_change=1e-14)

    def closure():
        opt.zero_grad()
        f = neg_log_posterior(u, Xp, Yp, hp, priors, prec)
        f.backward()
        return f

    with torch.enable_grad():
        opt.step(closure)
    lo, hi = box(priors, u.dtype, u.device)
    return torch.minimum(torch.maximum(u.detach(), lo), hi)


def fit_gap(u: torch.Tensor, X, Y, h: Hyper, priors: Priors) -> float:
    """How far the MAP objective at ``u`` lies above the optimum that a float64 fit
    reaches from ``u``, per training point: zero at a MAP optimum."""
    X, Y, h64 = X.double(), Y.double(), h.to(FP64)
    u = u.detach().double()
    f0 = float(neg_log_posterior(u, X, Y, h64, priors, FP64))
    u1 = fit_local(u, X, Y, h64, priors, FP64)
    f1 = float(neg_log_posterior(u1, X, Y, h64, priors, FP64))
    return max(0.0, f0 - min(f0, f1)) / X.shape[0]


class Posterior:
    """The GP posterior given the training rows ``X [n, D]``, ``Y [n, 1]``."""

    def __init__(self, X: torch.Tensor, Y: torch.Tensor, h: Hyper, prec: Precision):
        self.prec = prec
        self.h = h.to(prec)
        self.X = X.to(prec.dtype)
        self.Y = Y.to(prec.dtype)
        self.L = _train_cholesky(self.X, self.h, prec)
        self.alpha = torch.cholesky_solve(self.Y - self.h.mean, self.L)

    @property
    def scale(self) -> float:
        """The unit the gaps of scores are measured in: the signal's standard deviation."""
        return math.sqrt(float(self.h.variance))

    def _marginal(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        Kxn = kernel(x, self.X, self.h, self.prec)
        mean = matmul(Kxn, self.alpha, self.prec)[:, 0] + self.h.mean
        v = torch.linalg.solve_triangular(self.L, Kxn.T, upper=False)
        return mean, self.h.variance - (v * v).sum(0)

    def marginal(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and variance ``[N]`` at ``x [N, D]``, in blocks of rows."""
        x = x.to(self.prec.dtype)
        parts = [self._marginal(x[i:i + ROW_BLOCK]) for i in range(0, x.shape[0], ROW_BLOCK)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    def joint(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean ``[M, B]`` and covariance ``[M, B, B]`` of each batch in ``x [M, B, D]``."""
        x = x.to(self.prec.dtype)
        M, B, D = x.shape
        flat = x.reshape(M * B, D)
        Kxn = kernel(flat, self.X, self.h, self.prec)
        mean = (matmul(Kxn, self.alpha, self.prec)[:, 0] + self.h.mean).reshape(M, B)
        v = torch.linalg.solve_triangular(self.L, Kxn.T, upper=False).T.reshape(M, B, -1)
        cov = kernel(x, x, self.h, self.prec) - matmul(v, v.transpose(-1, -2), self.prec)
        return mean, cov

    def eta(self) -> torch.Tensor:
        """The incumbent: the least posterior mean over the training rows."""
        return self.marginal(self.X)[0].min()

    def trajectory(self, draws: Dict[str, Optional[torch.Tensor]]) -> Callable[[torch.Tensor], torch.Tensor]:
        """V posterior function draws ``x [N, V, D] -> [N, V]``, one per slice, made from
        the raw draws the program's trajectory took: ``frequency_normals [m, D]`` and
        ``chi2_normals [m, 5]`` (the spectral frequencies before the lengthscales),
        ``phase_uniforms [m]``, ``prior_weights [V, m]`` and ``noise_normals [V, C]``
        (``C`` the data's capacity, its first ``n`` columns for the ``n`` rows; ``None``
        where ``C`` exceeds ``m``).

        The features are ``phi(x) = sqrt(2s/m) cos(x W^T + b)`` with ``W = z sqrt(5/chi2)
        / l`` (a Matérn-5/2 spectral draw: a Student t with 5 degrees of freedom) and ``b
        = 2 pi u``. The draw is the posterior of the features' weights (Bayesian linear
        regression, Rasmussen and Williams section 2.1): where the data's capacity is at
        most ``m``, by the pathwise update ``theta = eps + Phi^T (Phi Phi^T + (noise +
        jitter) I)^-1 (y - Phi eps - sqrt(noise) eps_n)`` through its own Cholesky factor;
        else ``theta = mu + sqrt(noise) A^-T eps`` with ``A A^T = Phi^T Phi + (noise +
        jitter) I`` and ``mu = A^-T A^-1 Phi^T y``. Everything is worked out again here,
        in this posterior's precision."""
        prec, dt, h = self.prec, self.prec.dtype, self.h
        z = draws["frequency_normals"].to(dt)
        chi2 = torch.square(draws["chi2_normals"].to(dt)).sum(-1, keepdim=True)
        if draws["chi2_normals"].shape[-1] != MATERN52_DF:
            raise ValueError("a Matérn-5/2 spectral draw takes 5 normals a frequency")
        W = z * torch.sqrt(MATERN52_DF / chi2) / h.lengthscales  # [m, D]
        b = 2.0 * math.pi * draws["phase_uniforms"].to(dt)  # [m]
        m = W.shape[0]
        amplitude = torch.sqrt(2.0 * h.variance / m)

        def features(x: torch.Tensor) -> torch.Tensor:
            return amplitude * torch.cos(matmul(x, W.T, prec) + b)

        eps = draws["prior_weights"].to(dt)  # [V, m]
        Phi = features(self.X)  # [n, m]
        y = (self.Y - h.mean)[:, 0]  # [n]
        ridge = h.noise + h.jitter
        if draws.get("noise_normals") is not None:
            n = self.X.shape[0]
            eps_n = draws["noise_normals"][:, :n].to(dt)  # [V, n]
            eye = torch.eye(n, dtype=dt, device=Phi.device)
            L = torch.linalg.cholesky(matmul(Phi, Phi.T, prec) + ridge * eye)
            resid = y[None, :] - matmul(eps, Phi.T, prec) - math.sqrt(h.noise) * eps_n
            theta = eps + matmul(torch.cholesky_solve(resid.T, L).T, Phi, prec)  # [V, m]
        else:
            eye = torch.eye(m, dtype=dt, device=Phi.device)
            L = torch.linalg.cholesky(matmul(Phi.T, Phi, prec) + ridge * eye)
            mu = torch.cholesky_solve(matmul(Phi.T, y[:, None], prec), L)[:, 0]
            spread = torch.linalg.solve_triangular(L.T, eps.T, upper=True).T
            theta = mu[None, :] + math.sqrt(h.noise) * spread

        def f(x: torch.Tensor) -> torch.Tensor:
            x = x.to(dt)
            rows = max(1, TRAJECTORY_BLOCK // (x.shape[1] * m))
            return torch.cat([h.mean + (features(x[i:i + rows]) * theta).sum(-1)
                              for i in range(0, x.shape[0], rows)])

        return f


def normal_pdf(z: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def expected_improvement(mean: torch.Tensor, var: torch.Tensor, eta: torch.Tensor,
                         var_floor: float) -> torch.Tensor:
    """Analytic EI below ``eta``; ``var`` is floored at ``var_floor`` first."""
    std = torch.sqrt(torch.clamp_min(var, var_floor))
    z = (eta - mean) / std
    return (eta - mean) * torch.special.ndtr(z) + std * normal_pdf(z)


def batch_mc_expected_improvement(mean: torch.Tensor, cov: torch.Tensor, eta: torch.Tensor,
                                  eps: torch.Tensor, jitter: float,
                                  prec: Precision) -> torch.Tensor:
    """Monte-Carlo qEI of each batch: ``mean [M, B]``, ``cov [M, B, B]``, base draws
    ``eps [B, S]``; the samples are ``mean + chol(cov + jitter·I)·eps``."""
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    L = torch.linalg.cholesky_ex(cov + jitter * eye)[0]
    samples = mean[..., None] + matmul(L, eps.to(cov.dtype), prec)  # [M, B, S]
    improvement = torch.clamp_min(eta - samples.min(dim=-2).values, 0.0)
    return improvement.mean(-1)


def batched(fn, x: torch.Tensor, rows: int) -> torch.Tensor:
    """``fn`` over blocks of ``rows`` leading rows of ``x``, concatenated."""
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


def default_noise_and_priors(Y0: torch.Tensor, extent: torch.Tensor, dimension: int,
                             lengthscale_factor: float, signal_noise_ratio: float,
                             prior_scale: float, squeeze: float,
                             likelihood_variance: Optional[float] = None) -> Tuple[float, Priors]:
    """The fixed noise and the priors of a model built on the initial observations
    ``Y0``: the prior medians are the population variance of ``Y0`` (at least 1e-6) and
    ``lengthscale_factor · extent · √D``; the noise is ``likelihood_variance`` where the
    configuration states one, else that variance over the squared signal-to-noise ratio."""
    y_var = max(float(Y0.double().var(correction=0)), 1e-6) if Y0.shape[0] > 1 else 1.0
    ls = lengthscale_factor * extent.double() * math.sqrt(dimension)
    ls = torch.where(extent == 0, torch.ones_like(ls), ls)
    priors = Priors(var_loc=math.log(y_var), ls_loc=torch.log(ls), scale=prior_scale,
                    squeeze=squeeze)
    if likelihood_variance is not None:
        return float(likelihood_variance), priors
    return y_var / signal_noise_ratio**2, priors


__all__ = [
    "FP64", "TF32", "MATERN52_DF", "Hyper", "Posterior", "Precision", "Priors", "batch_mc_expected_improvement",
    "batched", "default_noise_and_priors", "expected_improvement", "fit_local", "pack",
    "fit_gap", "tf32_round", "unpack",
]
