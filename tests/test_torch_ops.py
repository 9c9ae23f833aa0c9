"""The port's numerical building blocks against the JAX package, in float64 on the CPU:
stationary kernels, masked linear algebra (padding invariance included) and the lockstep
batched L-BFGS. Inputs come from numpy with a fixed seed and go to both packages."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trieste_tpu.ops import kernels as jk
from trieste_tpu.ops import lbfgs as jl
from trieste_tpu.ops import linalg as jla
from trieste_tpu_torch.ops import kernels as tk
from trieste_tpu_torch.ops import lbfgs as tl
from trieste_tpu_torch.ops import linalg as tla

torch.set_num_threads(1)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-12)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _spd(rng: np.random.Generator, n: int) -> np.ndarray:
    a = rng.normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


@pytest.mark.parametrize("kind", tk.KINDS)
def test_gram_matches_jax(kind):
    rng = np.random.default_rng(0)
    a, b = rng.uniform(size=(7, 3)), rng.uniform(size=(5, 3))
    ls, var = np.array([0.4, 0.7, 1.3]), 1.7
    jkern = jk.stationary(kind, var, ls, dtype=jnp.float64)
    tkern = tk.stationary(kind, var, ls, dtype=F64, device="cpu")
    np.testing.assert_allclose(tk.gram(tkern, _t(a), _t(b)).numpy(), jk.gram(jkern, a, b), **TOL)
    np.testing.assert_allclose(tk.gram(tkern, _t(a)).numpy(), jk.gram(jkern, a), **TOL)
    np.testing.assert_allclose(tkern.diag(_t(a)).numpy(), jkern.diag(jnp.asarray(a)), **TOL)


def test_isotropic_lengthscale_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(6, 2))
    jd = jk.scaled_squared_distance(a, a, jnp.asarray(0.3))
    td = tk.scaled_squared_distance(_t(a), _t(a), _t([0.3]))
    np.testing.assert_allclose(td.numpy(), jd, **TOL)


def test_batched_hyperparameters_match_per_restart_grams():
    """A leading axis on the hyperparameters is a batch of Gram matrices."""
    rng = np.random.default_rng(2)
    X = rng.uniform(size=(9, 2))
    var = rng.uniform(0.5, 2.0, size=3)
    ls = rng.uniform(0.2, 1.0, size=(3, 2))
    batched = tk.Stationary(_t(var), _t(ls), "matern32")
    got = tk.gram(batched, _t(X)).numpy()
    for r in range(3):
        want = jk.gram(jk.stationary("matern32", var[r], ls[r], dtype=jnp.float64), X)
        np.testing.assert_allclose(got[r], want, **TOL)


def test_masked_cholesky_and_solves_match_jax():
    rng = np.random.default_rng(3)
    K = _spd(rng, 8)
    mask = np.arange(8) < 5
    b = rng.normal(size=(8, 2)) * mask[:, None]
    Lj = jla.masked_cholesky(K, mask)
    Lt = tla.masked_cholesky(_t(K), torch.as_tensor(mask))
    np.testing.assert_allclose(Lt.numpy(), Lj, **TOL)
    np.testing.assert_allclose(tla.masked_gram(_t(K), torch.as_tensor(mask)).numpy(),
                               jla.masked_gram(K, mask), **TOL)
    np.testing.assert_allclose(tla.solve_lower(Lt, _t(b)).numpy(), jla.solve_lower(Lj, b), **TOL)
    np.testing.assert_allclose(tla.solve_upper(Lt, _t(b)).numpy(), jla.solve_upper(Lj, b), **TOL)
    np.testing.assert_allclose(tla.cho_solve(Lt, _t(b)).numpy(), jla.cho_solve(Lj, b), **TOL)
    np.testing.assert_allclose(tla.masked_cholesky(_t(K)).numpy(), jla.masked_cholesky(K), **TOL)


def test_padding_invariance():
    """The padded system's factor, log-determinant and solves are the trimmed system's."""
    rng = np.random.default_rng(4)
    K = _spd(rng, 16)
    n = 6
    mask = torch.arange(16) < n
    b = np.zeros((16, 1))
    b[:n] = rng.normal(size=(n, 1))
    L_pad = tla.masked_cholesky(_t(K), mask)
    L_trim = tla.masked_cholesky(_t(K[:n, :n]))
    np.testing.assert_allclose(L_pad[:n, :n].numpy(), L_trim.numpy(), **TOL)
    np.testing.assert_array_equal(L_pad[n:, n:].numpy(), np.eye(16 - n))
    np.testing.assert_array_equal(L_pad[n:, :n].numpy(), 0.0)
    x_pad = tla.cho_solve(L_pad, _t(b))
    np.testing.assert_allclose(x_pad[:n].numpy(), tla.cho_solve(L_trim, _t(b[:n])).numpy(), **TOL)
    np.testing.assert_array_equal(x_pad[n:].numpy(), 0.0)
    logdet = lambda L: 2.0 * torch.log(torch.diagonal(L)).sum()  # noqa: E731
    np.testing.assert_allclose(logdet(L_pad).item(), logdet(L_trim).item(), **TOL)


def test_not_positive_definite_gives_nan_like_jax():
    """A failed factorization is NaN (as JAX returns), not an exception, and only in the
    batch element that failed."""
    bad = np.array([[1.0, 2.0], [2.0, 1.0]])
    good = np.eye(2) * 2.0
    want = np.asarray(jla.masked_cholesky(bad, jitter=0.0))
    L = tla.masked_cholesky(_t(np.stack([bad, good])), jitter=0.0)
    np.testing.assert_array_equal(L[0].numpy(), want)  # NaN lower triangle, zeros above
    assert np.isnan(want).sum() == 3
    np.testing.assert_allclose(L[1].numpy(), np.sqrt(2.0) * np.eye(2), **TOL)


# -- L-BFGS ----------------------------------------------------------------------------

_C = np.array([0.3, -0.2, 0.8])
_W = np.array([1.0, 4.0, 0.5])


def _jax_fn(x):
    return jnp.sum(_W * (x - _C) ** 2) + 0.3 * (x[0] * x[1]) ** 2 + 0.1 * jnp.sum(x**4)


def _torch_fn(x):  # [R, 3] -> [R]: each row's value depends on that row only
    c, w = _t(_C), _t(_W)
    return torch.sum(w * (x - c) ** 2, -1) + 0.3 * (x[:, 0] * x[:, 1]) ** 2 + 0.1 * torch.sum(x**4, -1)


@pytest.mark.parametrize("bounded", [False, True], ids=["free", "box"])
def test_lbfgs_iterates_match_jax(bounded):
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-2.0, 2.0, size=(5, 3))
    lower, upper = (np.full(3, -0.1), np.full(3, 0.5)) if bounded else (None, None)
    kw = dict(max_iters=40, memory=4)
    want = jl.vmapped_minimize_lbfgs(_jax_fn, jnp.asarray(x0), lower, upper, **kw)
    got = tl.minimize_lbfgs(
        _torch_fn, _t(x0), None if lower is None else _t(lower),
        None if upper is None else _t(upper), **kw,
    )
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.fun.numpy(), want.fun, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(got.num_iters.numpy(), np.asarray(want.num_iters))
    np.testing.assert_array_equal(got.num_fun_evals.numpy(), np.asarray(want.num_fun_evals))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))


def test_lbfgs_truncated_runs_match_jax():
    """Runs cut by ``max_iters`` stop at the same iterate as JAX's, while others converge."""
    rng = np.random.default_rng(6)
    x0 = rng.uniform(-3.0, 3.0, size=(4, 3))
    x0[0] = _C  # already near the optimum: converges at once
    want = jl.vmapped_minimize_lbfgs(_jax_fn, jnp.asarray(x0), max_iters=3)
    got = tl.minimize_lbfgs(_torch_fn, _t(x0), max_iters=3)
    np.testing.assert_allclose(got.x.numpy(), want.x, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(got.num_iters.numpy(), np.asarray(want.num_iters))


def test_lbfgs_non_finite_rows_lose_without_stopping_others():
    """A run whose objective is non-finite ends with +inf; the others still converge."""

    def fn(x):
        f = torch.sum((x - 1.0) ** 2, -1)
        return torch.where(x[:, 0] > 5.0, torch.nan, f)

    res = tl.minimize_lbfgs(fn, _t([[0.0, 0.0], [10.0, 0.0]]))
    np.testing.assert_allclose(res.x[0].numpy(), [1.0, 1.0], atol=1e-6)
    assert bool(res.converged[0])
    assert torch.isinf(res.fun[1])
