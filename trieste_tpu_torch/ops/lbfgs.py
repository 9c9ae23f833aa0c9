"""Box-constrained L-BFGS over a batch of runs in lockstep (counterpart of
:mod:`trieste_tpu.ops.lbfgs`, which ``vmap``s one run under ``lax.while_loop``).

``x: [R, n]`` holds R independent runs. The objective maps ``[R, n] -> [R]`` with row r
of the value depending on row r of the input only, so ``autograd.grad(f.sum(), x)`` gives
every run its own gradient and one call of the objective serves all runs. Each run keeps
its own history, step sizes, line-search state and done flag; a finished run stops
changing while the others go on, which is exactly the per-run semantics of the vmapped
JAX loop. The loops are Python loops with one device-to-host read per iteration (the
"any run still going?" test).

The algorithm is the JAX package's: the two-loop recursion over a circular history,
backtracking Armijo search along the projected path, and convergence on the projected
gradient ``x − clip(x − g)`` (scipy L-BFGS-B's criterion) or on the relative change of f.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

GTOL = 1e-6  # projected-gradient convergence
FTOL = 1e-10  # relative-change convergence
MAX_LINE_SEARCH = 25
ARMIJO_C1 = 1e-4


class LBFGSResults(NamedTuple):
    x: torch.Tensor  # [R, n] final iterates
    fun: torch.Tensor  # [R] final objective values
    converged: torch.Tensor  # [R] bool: gradient/ftol convergence reached
    num_iters: torch.Tensor  # [R] iterations taken
    num_fun_evals: torch.Tensor  # [R] objective evaluations, line search included


def _two_loop(
    g: torch.Tensor,
    s_hist: torch.Tensor,
    y_hist: torch.Tensor,
    rho: torch.Tensor,
    hk: torch.Tensor,
    gamma: torch.Tensor,
) -> torch.Tensor:
    """Batched two-loop recursion over circular histories ``[R, m, n]``; empty slots carry
    ``rho == 0`` so their contributions vanish."""
    R, m, _ = s_hist.shape
    rows = torch.arange(R, device=g.device)
    num_pairs = torch.clamp_max(hk, m)
    q = g
    alphas = torch.zeros_like(rho)
    for i in range(m):
        idx = torch.remainder(hk - 1 - i, m)
        a = rho[rows, idx] * torch.sum(s_hist[rows, idx] * q, dim=-1)
        q = q - a[:, None] * y_hist[rows, idx]
        alphas[rows, idx] = a
    r = gamma[:, None] * q
    for j in range(m):
        idx = torch.remainder(hk - num_pairs + j, m)
        b = rho[rows, idx] * torch.sum(y_hist[rows, idx] * r, dim=-1)
        r = r + (alphas[rows, idx] - b)[:, None] * s_hist[rows, idx]
    return r


def minimize_lbfgs(
    fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
    *,
    memory: int = 10,
    max_iters: int = 100,
) -> LBFGSResults:
    """Minimize every row of ``x0 [R, n]`` under ``fn: [R, n] -> [R]``, within optional
    bounds ``[n]`` or ``[R, n]``."""
    R, n = x0.shape
    dtype, device = x0.dtype, x0.device
    lo = torch.full((n,), -torch.inf, dtype=dtype, device=device) if lower is None else lower
    hi = torch.full((n,), torch.inf, dtype=dtype, device=device) if upper is None else upper

    def project(x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, lo, hi)

    def proj_grad_norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return torch.amax(torch.abs(x - project(x - g)), dim=-1)

    def safe_f(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            f = fn(x)
        return torch.where(torch.isfinite(f), f, torch.inf)

    def safe_vg(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = fn(xg)
            if f.requires_grad:
                (g,) = torch.autograd.grad(f.sum(), xg)
            else:  # an objective that does not depend on x
                g = torch.zeros_like(x)
        f = torch.where(torch.isfinite(f), f.detach(), torch.inf)
        g = torch.where(torch.isfinite(g), g, 0.0)
        return f, g

    def line_search(x, f, g, d, active):
        """Backtracking Armijo over the projected path ``project(x + a*d)``."""
        a = torch.ones(R, dtype=dtype, device=device)
        ls_it = torch.zeros(R, dtype=torch.long, device=device)
        x_best, f_best = x, f
        ok = torch.zeros(R, dtype=torch.bool, device=device)
        searching = active
        while bool(searching.any()):
            xn = project(x + a[:, None] * d)
            fn_val = safe_f(xn)
            decrease = fn_val <= f + ARMIJO_C1 * torch.sum(g * (xn - x), dim=-1)
            moved = torch.amax(torch.abs(xn - x), dim=-1) > 0
            good = searching & decrease & moved
            x_best = torch.where(good[:, None], xn, x_best)
            f_best = torch.where(good, fn_val, f_best)
            ok = torch.where(searching, good, ok)
            a = torch.where(searching, a * 0.5, a)
            ls_it = ls_it + searching.long()
            searching = searching & ~ok & (ls_it < MAX_LINE_SEARCH)
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
    converged = proj_grad_norm(x, g) <= GTOL
    done = converged.clone()
    while not bool(done.all()):
        active = ~done
        d = -_two_loop(g, s_hist, y_hist, rho, hk, gamma)
        # fall back to steepest descent where d is not a descent direction
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
        step = active & ls_ok
        f_old = f
        x = torch.where(step[:, None], x_new, x)
        f = torch.where(step, f_new, f)
        g = torch.where(step[:, None], g_new, g)
        f_rel = torch.abs(f_old - f) / torch.clamp_min(torch.maximum(torch.abs(f), torch.abs(f_old)), 1.0)
        conv_now = (proj_grad_norm(x, g) <= GTOL) | (ls_ok & (f_rel <= FTOL))
        it = it + active.long()
        converged = torch.where(active, conv_now, converged)
        done = done | (active & (conv_now | ~ls_ok | (it >= max_iters)))
        evals = evals + active.long() * (ls_evals + 1)
    return LBFGSResults(x, f, converged, it, evals)
