"""Box-constrained L-BFGS over a batch of runs in lockstep (counterpart of
:mod:`trieste_tpu.ops.lbfgs`, which ``vmap``s one run under ``lax.while_loop``).

``x: [R, n]`` holds R independent runs. The objective is one function of a row, applied to
every row of its input: it maps ``[k, n] -> [k]`` for any ``k``, row i of the value
depending on row i of the input only. So ``autograd.grad(f.sum(), x)`` gives every run its
own gradient, one call of the objective serves all runs, and the line search may stack the
candidates of several runs into one call. A call that returns another shape raises
``ValueError``. Each run keeps its own history, step sizes, line-search state and done
flag; a finished run stops changing while the others go on, which is exactly the per-run
semantics of the vmapped JAX loop.

The loops are Python loops over device-to-host reads: each iteration's "how many runs are
still going?", and in each line search the rows still searching after the full step and
after each block of halvings that does not reach the last one. The counts feed the module's
counters (:func:`trieste_tpu_torch.profiling.counters`) and the spans of a call
(``lbfgs.minimize``) and of each iteration's phases (``lbfgs.direction``,
``lbfgs.line_search``, ``lbfgs.gradient``); the evaluations the runs counted cost one read
at the end of a call.

The algorithm is the JAX package's: the two-loop recursion over a circular history,
backtracking Armijo search along the projected path, and convergence on the projected
gradient ``x − clip(x − g)`` (scipy L-BFGS-B's criterion) or on the relative change of f.
The search's halvings depend only on x, d and their index, so the runs still searching
after the full step evaluate the next K step sizes ``2⁻ᵏ`` in one call of ``S·K`` rows,
``K = ⌊2R / S⌋`` or the halvings left, and each takes its first step that passes Armijo's
test: the accepted point, value and evaluation count of the search one halving at a time.
A call thus holds at most 2R rows, twice the rows of the gradient phase, which evaluates
the same objective with autograd's saved tensors. An acquisition's runs hold ``V`` points
each, so a block can hold ``2R·V`` rows; from ``R·V ≥ 1024`` it can cross the fused
prediction kernel's 2048-row gate, and those rows are then scored within the kernel's
precision contract.

Under a mesh each rank runs its own block of the runs, and ranks make different numbers of
calls and reads; this holds only while no objective makes a collective call, and none does
(``parallel/collectives.py`` calls them outside every objective).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..profiling import host_read, span

GTOL = 1e-6  # projected-gradient convergence
FTOL = 1e-10  # relative-change convergence
MAX_LINE_SEARCH = 25
ARMIJO_C1 = 1e-4

iterations = 0
"""Lockstep iterations, over all calls: turns of the host loop."""
line_search_turns = 0
"""Objective calls of the line search, over all calls: the full step and each block of
halvings, each followed by at most one read."""
line_search_blocks = 0
"""The line search's objective calls past the full step (blocks of halvings)."""
block_rows = 0
"""Rows given to the objective in :data:`line_search_blocks`."""
rows_evaluated = 0
"""Rows given to the objective, over all calls: R per gradient and full step, and the rows
of each block."""
rows_active = 0
"""The evaluations that count in ``LBFGSResults.num_fun_evals``: those a search one
halving at a time would make for the runs still going."""


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
    """Minimize every row of ``x0 [R, n]`` under ``fn: [k, n] -> [k]``, one function of
    each row for any number of rows ``k``, within optional bounds ``[n]`` or ``[R, n]``.

    This batched form is the counterpart of the JAX package's ``vmapped_minimize_lbfgs``
    and is exported under that name too. The JAX ``minimize_lbfgs`` takes one start
    ``x0 [n]`` and a scalar objective ``f``; here that is the batch of one run,
    ``minimize_lbfgs(torch.vmap(f), x0[None])``."""
    global iterations, line_search_turns, line_search_blocks, block_rows
    global rows_evaluated, rows_active
    R, n = x0.shape
    dtype, device = x0.dtype, x0.device
    lo = torch.full((n,), -torch.inf, dtype=dtype, device=device) if lower is None else lower
    hi = torch.full((n,), torch.inf, dtype=dtype, device=device) if upper is None else upper
    turns = blocks = rows_in_blocks = 0  # this call's line-search calls, blocks and their rows
    evaluated = R  # rows given to the objective: the first evaluation's are all

    def project(x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, lo, hi)

    def proj_grad_norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return torch.amax(torch.abs(x - project(x - g)), dim=-1)

    def checked(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if f.shape != x.shape[:1]:
            raise ValueError(
                f"the objective must map [k, n] to [k]; it gave {tuple(f.shape)} for "
                f"{tuple(x.shape)}")
        return f

    def safe_f(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            f = checked(fn(x), x)
        return torch.where(torch.isfinite(f), f, torch.inf)

    def safe_vg(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = checked(fn(xg), xg)
            if f.requires_grad:
                (g,) = torch.autograd.grad(f.sum(), xg)
            else:  # an objective that does not depend on x
                g = torch.zeros_like(x)
        f = torch.where(torch.isfinite(f), f.detach(), torch.inf)
        g = torch.where(torch.isfinite(g), g, 0.0)
        return f, g

    # the step sizes 1, 1/2, ..., 2^-(MAX_LINE_SEARCH-1), each exact
    steps = torch.full((MAX_LINE_SEARCH,), 0.5, dtype=dtype, device=device).cumprod(0) * 2.0

    def armijo(xn, fn_val, x, f, g):
        """Armijo's sufficient decrease, and a move off ``x``, over the last axis."""
        decrease = fn_val <= f + ARMIJO_C1 * torch.sum(g * (xn - x), dim=-1)
        return decrease & (torch.amax(torch.abs(xn - x), dim=-1) > 0)

    def line_search(x, f, g, d, active):
        """Backtracking Armijo over the projected path ``project(x + a*d)``: the full step
        for every row, then blocks of halvings for the rows still searching."""
        nonlocal turns, blocks, rows_in_blocks, evaluated
        turns += 1
        evaluated += R
        xn = project(x + d)
        fn_val = safe_f(xn)
        ok = active & armijo(xn, fn_val, x, f, g)
        x_best = torch.where(ok[:, None], xn, x)
        f_best = torch.where(ok, fn_val, f)
        ls_it = active.long()
        rows = (active & ~ok).nonzero()[:, 0]  # the runs still searching, and how many
        host_read("lbfgs.line_search")
        k0 = 1  # the next halving
        while rows.shape[0]:
            S = rows.shape[0]
            K = min(MAX_LINE_SEARCH - k0, max(1, 2 * R // S))
            turns += 1
            blocks += 1
            rows_in_blocks += S * K
            evaluated += S * K
            xs, fs, gs, ds = x[rows], f[rows], g[rows], d[rows]
            bounds = [b if b.dim() == 1 else b.expand(R, n)[rows][:, None] for b in (lo, hi)]
            xn = torch.clamp(xs[:, None] + steps[k0:k0 + K, None] * ds[:, None], *bounds)
            fn_val = safe_f(xn.reshape(S * K, n)).reshape(S, K)  # [S, K]
            good = armijo(xn, fn_val, xs[:, None], fs[:, None], gs[:, None])
            first = torch.argmax(good.int(), dim=1)  # the first accepted halving, if any
            found = good.any(dim=1)
            x_best.index_copy_(0, rows, torch.where(
                found[:, None], xn.gather(1, first.view(S, 1, 1).expand(S, 1, n))[:, 0], xs))
            f_best.index_copy_(0, rows, torch.where(
                found, fn_val.gather(1, first[:, None])[:, 0], fs))
            ok.index_copy_(0, rows, found)
            ls_it.index_copy_(0, rows, torch.where(found, first + (k0 + 1), k0 + K))
            k0 += K
            if k0 == MAX_LINE_SEARCH:
                break
            rows = rows[~found]
            host_read("lbfgs.line_search")
        return x_best, f_best, ls_it, ok

    with span("lbfgs.minimize", R=R, n=n) as record:
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
        live = R - int(done.sum())  # runs still going
        host_read("lbfgs.loop")
        iters = 0
        while live:
            iters += 1
            evaluated += R  # this iteration's gradient evaluation
            active = ~done
            with span("lbfgs.direction"):
                d = -_two_loop(g, s_hist, y_hist, rho, hk, gamma)
                # fall back to steepest descent where d is not a descent direction
                d = torch.where((torch.sum(d * g, dim=-1) < 0)[:, None], d, -g)
            with span("lbfgs.line_search"):
                x_new, f_new, ls_evals, ls_ok = line_search(x, f, g, d, active)
            with span("lbfgs.gradient"):
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
                gamma = torch.where(
                    accept, sy / torch.clamp_min(torch.sum(yk * yk, dim=-1), 1e-30), gamma)
                step = active & ls_ok
                f_old = f
                x = torch.where(step[:, None], x_new, x)
                f = torch.where(step, f_new, f)
                g = torch.where(step[:, None], g_new, g)
                f_rel = torch.abs(f_old - f) / torch.clamp_min(
                    torch.maximum(torch.abs(f), torch.abs(f_old)), 1.0)
                conv_now = (proj_grad_norm(x, g) <= GTOL) | (ls_ok & (f_rel <= FTOL))
                it = it + active.long()
                converged = torch.where(active, conv_now, converged)
                done = done | (active & (conv_now | ~ls_ok | (it >= max_iters)))
                evals = evals + active.long() * (ls_evals + 1)
                live = R - int(done.sum())
                host_read("lbfgs.loop")
        active_rows = int(evals.sum())
        host_read("lbfgs.minimize")
        if record is not None:
            record.attrs.update(iterations=iters, line_search_turns=turns,
                                line_search_blocks=blocks, block_rows=rows_in_blocks,
                                rows_evaluated=evaluated, rows_active=active_rows)
    iterations += iters
    line_search_turns += turns
    line_search_blocks += blocks
    block_rows += rows_in_blocks
    rows_evaluated += evaluated
    rows_active += active_rows
    return LBFGSResults(x, f, converged, it, evals)


vmapped_minimize_lbfgs = minimize_lbfgs
"""The JAX package's name for L-BFGS over a batch of starts, which the port's
:func:`minimize_lbfgs` is."""
