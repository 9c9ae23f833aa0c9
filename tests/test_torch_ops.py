"""The port's numerical building blocks against the JAX package, in float64 on the CPU:
stationary kernels, masked linear algebra (padding invariance included) and the lockstep
batched L-BFGS, whose line search in blocks of halvings is also held bit for bit to the
search one halving at a time. Inputs come from numpy with a fixed seed and go to both
packages."""
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


# -- the line search's blocks against the search one halving at a time ------------------


def sequential_minimize_lbfgs(fn, x0, lower=None, upper=None, *, memory=10, max_iters=100,
                              searches=None):
    """The loop with one objective call and one ``bool`` read per halving of the line
    search. ``searches``, a list, receives each line search's ``(active, ls_it)``."""
    R, n = x0.shape
    dtype, device = x0.dtype, x0.device
    lo = torch.full((n,), -torch.inf, dtype=dtype, device=device) if lower is None else lower
    hi = torch.full((n,), torch.inf, dtype=dtype, device=device) if upper is None else upper

    def project(x):
        return torch.clamp(x, lo, hi)

    def proj_grad_norm(x, g):
        return torch.amax(torch.abs(x - project(x - g)), dim=-1)

    def safe_f(x):
        with torch.no_grad():
            f = fn(x)
        return torch.where(torch.isfinite(f), f, torch.inf)

    def safe_vg(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = fn(xg)
            (g,) = torch.autograd.grad(f.sum(), xg)
        f = torch.where(torch.isfinite(f), f.detach(), torch.inf)
        g = torch.where(torch.isfinite(g), g, 0.0)
        return f, g

    def line_search(x, f, g, d, active):
        a = torch.ones(R, dtype=dtype, device=device)
        ls_it = torch.zeros(R, dtype=torch.long, device=device)
        x_best, f_best = x, f
        ok = torch.zeros(R, dtype=torch.bool, device=device)
        searching = active
        while bool(searching.any()):
            xn = project(x + a[:, None] * d)
            fn_val = safe_f(xn)
            decrease = fn_val <= f + tl.ARMIJO_C1 * torch.sum(g * (xn - x), dim=-1)
            moved = torch.amax(torch.abs(xn - x), dim=-1) > 0
            good = searching & decrease & moved
            x_best = torch.where(good[:, None], xn, x_best)
            f_best = torch.where(good, fn_val, f_best)
            ok = torch.where(searching, good, ok)
            a = torch.where(searching, a * 0.5, a)
            ls_it = ls_it + searching.long()
            searching = searching & ~ok & (ls_it < tl.MAX_LINE_SEARCH)
        if searches is not None:
            searches.append((active, ls_it))
        return x_best, f_best, ls_it, ok

    x = project(x0)
    f, g = safe_vg(x)
    s_hist = torch.zeros((R, memory, n), dtype=dtype, device=device)
    y_hist = torch.zeros((R, memory, n), dtype=dtype, device=device)
    rho = torch.zeros((R, memory), dtype=dtype, device=device)
    hk = torch.zeros(R, dtype=torch.long, device=device)
    gamma = torch.ones(R, dtype=dtype, device=device)
    it = torch.zeros(R, dtype=torch.long, device=device)
    evals = torch.ones(R, dtype=torch.long, device=device)
    converged = proj_grad_norm(x, g) <= tl.GTOL
    done = converged.clone()
    while not bool(done.all()):
        active = ~done
        d = -tl._two_loop(g, s_hist, y_hist, rho, hk, gamma)
        d = torch.where((torch.sum(d * g, dim=-1) < 0)[:, None], d, -g)
        x_new, f_new, ls_evals, ls_ok = line_search(x, f, g, d, active)
        _, g_new = safe_vg(x_new)
        sk = x_new - x
        yk = g_new - g
        sy = torch.sum(sk * yk, dim=-1)
        accept = active & ls_ok & (sy > 1e-10)
        slot = torch.nn.functional.one_hot(torch.remainder(hk, memory), memory).bool()
        write = slot & accept[:, None]
        s_hist = torch.where(write[..., None], sk[:, None, :], s_hist)
        y_hist = torch.where(write[..., None], yk[:, None, :], y_hist)
        rho = torch.where(write, (1.0 / torch.clamp_min(sy, 1e-30))[:, None], rho)
        hk = hk + accept.long()
        gamma = torch.where(accept, sy / torch.clamp_min(torch.sum(yk * yk, dim=-1), 1e-30), gamma)
        step_ = active & ls_ok
        f_old = f
        x = torch.where(step_[:, None], x_new, x)
        f = torch.where(step_, f_new, f)
        g = torch.where(step_[:, None], g_new, g)
        f_rel = torch.abs(f_old - f) / torch.clamp_min(torch.maximum(torch.abs(f), torch.abs(f_old)), 1.0)
        conv_now = (proj_grad_norm(x, g) <= tl.GTOL) | (ls_ok & (f_rel <= tl.FTOL))
        it = it + active.long()
        converged = torch.where(active, conv_now, converged)
        done = done | (active & (conv_now | ~ls_ok | (it >= max_iters)))
        evals = evals + active.long() * (ls_evals + 1)
    return tl.LBFGSResults(x, f, converged, it, evals)


def block_schedule(searches, R):
    """``(blocks, their rows, the reads after them)`` that the block search makes for the
    searches of :func:`sequential_minimize_lbfgs`: a row accepted at halving k took k + 1
    turns there, and a failed one ``MAX_LINE_SEARCH``."""
    blocks = rows = reads = 0
    for active, ls_it in searches:
        k0, left = 1, active & (ls_it > 1)  # still searching after the full step
        while int(left.sum()):
            S = int(left.sum())
            K = min(tl.MAX_LINE_SEARCH - k0, max(1, 2 * R // S))
            blocks, rows, k0 = blocks + 1, rows + S * K, k0 + K
            if k0 == tl.MAX_LINE_SEARCH:
                break
            left, reads = left & (ls_it > k0), reads + 1
    return blocks, rows, reads


def _ridge(x):  # [k, 3] -> [k]: one function of each row
    return 0.5 * (x[:, 0] - 3.0) ** 2 + 8.0 * x[:, 1] ** 2 + 1e20 * x[:, 2] ** 2


def _jax_ridge(x):
    return 0.5 * (x[0] - 3.0) ** 2 + 8.0 * x[1] ** 2 + 1e20 * x[2] ** 2


# the first searches: the full step passes (on the minimum, or clipped to 2.5 with bounds per
# run); 4 halvings in x1's valley; 3 with both terms; every one of the 25 step sizes
# overshoots x2's wall; the full step again
_RIDGE_X0 = [[1.0, 0.0, 0.0], [3.0, 0.5, 0.0], [0.0, 0.3, 0.0], [3.0, 0.0, 1.0], [5.0, 0.0, 0.0]]


@pytest.mark.parametrize("bounds", ["free", "box", "per_run"])
def test_lbfgs_blocks_are_the_search_one_halving_at_a_time(bounds):
    """Searches that end at the full step, after several halvings and after all 25, with
    bounds ``[n]``, ``[R, n]`` or none: bit for bit the results of the search one halving
    at a time, still the JAX package's, and no call of more than 2R rows."""
    x0 = _t(_RIDGE_X0)
    R = x0.shape[0]
    lower, upper = {
        "free": (None, None),
        "box": (_t([-4.0, -4.0, -4.0]), _t([4.0, 4.0, 4.0])),
        "per_run": (_t([[-4.0] * 3] * R), _t([[2.5, 4.0, 4.0], [4.0, 4.0, 4.0]] * 2 + [[4.0] * 3])),
    }[bounds]
    rows = []

    def recorded(x):
        rows.append(x.shape[0])
        return _ridge(x)

    searches = []
    want = sequential_minimize_lbfgs(_ridge, x0, lower, upper, searches=searches)
    got = tl.minimize_lbfgs(recorded, x0, lower, upper)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert searches[0][1].tolist() == [1, 5, 4, 25, 1]  # the first searches' turns
    assert max(rows) <= 2 * R and sum(r != R for r in rows) == block_schedule(searches, R)[0] > 3

    jwant = jl.vmapped_minimize_lbfgs(
        _jax_ridge, jnp.asarray(_RIDGE_X0), None if lower is None else lower.numpy(),
        None if upper is None else upper.numpy())
    np.testing.assert_allclose(got.x.numpy(), jwant.x, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.fun.numpy(), jwant.fun, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(got.num_iters.numpy(), np.asarray(jwant.num_iters))
    np.testing.assert_array_equal(got.num_fun_evals.numpy(), np.asarray(jwant.num_fun_evals))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(jwant.converged))


@pytest.mark.parametrize("wrong", ["column", "first_row"])
def test_lbfgs_refuses_an_objective_of_another_shape(wrong):
    """A value ``[k, 1]``, or ``[1]`` from the first row alone, would score every
    candidate of a block alike: the objective must map ``[k, n]`` to ``[k]``."""
    fn = {"column": lambda x: _ridge(x)[:, None],
          "first_row": lambda x: _ridge(x[:1])}[wrong]
    with pytest.raises(ValueError, match=r"\[k, n\] to \[k\]"):
        tl.minimize_lbfgs(fn, _t(_RIDGE_X0[1:2]))
