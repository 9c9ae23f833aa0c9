"""Hamiltonian Monte Carlo with dual-averaging warmup (counterpart of
:mod:`trieste_tpu.ops.hmc`).

Chains run in lockstep as the leading batch axis of ``q [chains, D]``: the log density
maps ``[chains, D] -> [chains]``, row c depending on row c of the input only, so one call
and one ``autograd.grad`` of its sum serve every chain. A transition reads nothing back
from the device: acceptance and the dual-averaging state are ``torch.where`` on tensors,
and only the transition counter, which the host knows, steers Python.

The leapfrog evaluates the gradient once per position: the gradient at the end of one
step is the one the next step starts from, and a transition starts from the gradient and
log density carried at its ``q`` (the JAX package evaluates both twice; the results are
the same). A rejected transition keeps the old ``q`` and, with it, the old gradient and
log density. Where the log density is not finite (a failed Cholesky) its gradient is
NaN, so the trajectory turns NaN and the proposal is rejected.

A transition updates the chains' state in place. On the card it is captured once per
sampler call as a CUDA graph and replayed: at small capacities a gradient evaluation is
some 250 launches of tiny kernels, which the host cannot issue as fast as the card runs
them. The capture synchronizes once; the transitions do not.

The sampler is split as every drawing function of the port is: :func:`draw_hmc` takes
the momenta and acceptance uniforms from a ``torch.Generator``, and
:func:`hmc_sample_from_draws` is a pure function of them.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..utils.misc import standard_normal, uniform

LogDensity = Callable[[torch.Tensor], torch.Tensor]


class HMCResults(NamedTuple):
    samples: torch.Tensor  # [chains, num_samples, D]
    accept_rate: torch.Tensor  # [chains] mean acceptance probability over the samples
    step_size: torch.Tensor  # [chains] adapted step size
    num_nonfinite: torch.Tensor  # [chains] log-density evaluations that were not finite


def _log_density_and_grad(log_prob: LogDensity, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(log_prob(q) or -inf where not finite [chains], its gradient [chains, D], NaN
    where the value is not finite)``."""
    with torch.enable_grad():
        q = q.detach().requires_grad_(True)
        lp = log_prob(q)
        (grad,) = torch.autograd.grad(lp.sum(), q)
    finite = torch.isfinite(lp.detach())
    lp = torch.where(finite, lp.detach(), -torch.inf)
    return lp, torch.where(finite[:, None], grad, torch.nan)


def draw_hmc(
    generator: Optional[torch.Generator], num_transitions: int, num_chains: int, dimension: int,
    like: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each transition's momentum ``[T, chains, D]`` and acceptance uniform ``[T, chains]``,
    with the dtype and device of ``like``."""
    momenta = standard_normal(generator, (num_transitions, num_chains, dimension), like)
    uniforms = uniform(generator, (num_transitions, num_chains), like)
    return momenta, uniforms


class _State(NamedTuple):
    """The chains' state, updated in place by each transition: ``q [chains, D]``, its log
    density and gradient, and the transition's inputs (step ``[chains, 1]``, momentum,
    uniform) and outputs (acceptance probability, non-finite evaluations so far)."""

    q: torch.Tensor
    lp: torch.Tensor
    grad: torch.Tensor
    step: torch.Tensor
    p0: torch.Tensor
    u: torch.Tensor
    alpha: torch.Tensor
    num_nonfinite: torch.Tensor


def _transition(log_prob: LogDensity, num_leapfrog: int, state: _State) -> None:
    """One transition in place: a leapfrog trajectory from ``(q, p0)``, then a Metropolis
    step that keeps ``q`` (with its log density and gradient) or moves to the end."""
    q_new, p, g_new = state.q, state.p0, state.grad
    nonfinite = torch.zeros_like(state.num_nonfinite)
    for _ in range(num_leapfrog):
        p = p + 0.5 * state.step * g_new
        q_new = q_new + state.step * p
        lp_new, g_new = _log_density_and_grad(log_prob, q_new)
        nonfinite = nonfinite + (~torch.isfinite(lp_new)).to(nonfinite.dtype)
        p = p + 0.5 * state.step * g_new
    h0 = state.lp - 0.5 * torch.sum(state.p0**2, dim=-1)
    h1 = lp_new - 0.5 * torch.sum(p**2, dim=-1)
    log_alpha = torch.minimum(h1 - h0, torch.zeros_like(h1))
    alpha = torch.where(torch.isfinite(log_alpha), torch.exp(log_alpha), 0.0)
    accept = state.u < alpha
    q = torch.where(accept[:, None], q_new, state.q)
    lp = torch.where(accept, lp_new, state.lp)
    grad = torch.where(accept[:, None], g_new, state.grad)
    state.q.copy_(q)
    state.lp.copy_(lp)
    state.grad.copy_(grad)
    state.alpha.copy_(alpha)
    state.num_nonfinite.add_(nonfinite)


def _transition_runner(log_prob: LogDensity, num_leapfrog: int, state: _State) -> Callable[[], None]:
    """A function that runs one transition on ``state``. On the card it replays a CUDA
    graph of the transition, captured here once: a transition is some 250 small launches
    per gradient evaluation, and the graph takes the host out of them."""
    if not state.q.is_cuda:
        return partial(_transition, log_prob, num_leapfrog, state)
    scratch = _State(*(t.clone() for t in state))
    with torch.cuda.device(state.q.device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # initializes what the capture records, on a copy
            _transition(log_prob, num_leapfrog, scratch)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _transition(log_prob, num_leapfrog, state)
    return graph.replay


def hmc_sample_from_draws(
    log_prob: LogDensity,
    initial: torch.Tensor,
    momenta: torch.Tensor,
    uniforms: torch.Tensor,
    *,
    num_warmup: int = 100,
    num_leapfrog: int = 12,
    initial_step_size: float = 0.1,
    target_accept: float = 0.75,
) -> HMCResults:
    """Run ``T = momenta.shape[0]`` transitions of every chain from ``initial [chains, D]``:
    the first ``num_warmup`` adapt each chain's step size by dual averaging (Hoffman and
    Gelman 2014) towards ``target_accept``, the rest keep the averaged step and are the
    samples."""
    total = momenta.shape[0]
    if total <= num_warmup:
        raise ValueError(f"{total} transitions leave no sample after {num_warmup} of warmup")
    lp, grad = _log_density_and_grad(log_prob, initial)
    state = _State(
        q=initial.clone(), lp=lp, grad=grad, step=torch.empty_like(initial[:, :1]),
        p0=torch.empty_like(initial), u=torch.empty_like(lp), alpha=torch.empty_like(lp),
        num_nonfinite=(~torch.isfinite(lp)).to(torch.int64),
    )
    run = _transition_runner(log_prob, num_leapfrog, state)
    log_eps = torch.full_like(lp, math.log(initial_step_size))
    log_eps_bar = log_eps.clone()
    h_bar = torch.zeros_like(lp)
    mu = math.log(10.0 * initial_step_size)
    samples, alphas = [], []
    for t in range(total):
        warmup = t < num_warmup
        state.step.copy_(torch.exp(log_eps if warmup else log_eps_bar)[:, None])
        state.p0.copy_(momenta[t])
        state.u.copy_(uniforms[t])
        run()
        alpha = state.alpha.clone()
        if warmup:  # the host knows the step counter, so only tensors of state are updated
            t_new = float(t + 1)
            eta = 1.0 / (t_new + 10.0)
            h_bar = (1.0 - eta) * h_bar + eta * (target_accept - alpha)
            log_eps = mu - math.sqrt(t_new) / 0.05 * h_bar
            weight = t_new ** (-0.75)
            log_eps_bar = weight * log_eps + (1.0 - weight) * log_eps_bar
        else:
            samples.append(state.q.clone())
            alphas.append(alpha)
    return HMCResults(
        samples=torch.stack(samples, dim=1),
        accept_rate=torch.stack(alphas).mean(dim=0),
        step_size=torch.exp(log_eps_bar),
        num_nonfinite=state.num_nonfinite.clone(),
    )


def hmc_sample(
    generator: Optional[torch.Generator],
    log_prob: LogDensity,
    initial: torch.Tensor,
    *,
    num_samples: int = 100,
    num_warmup: int = 100,
    num_leapfrog: int = 12,
    initial_step_size: float = 0.1,
    target_accept: float = 0.75,
) -> HMCResults:
    """Sample ``exp(log_prob)`` from ``initial [chains, D]``, draws from ``generator``."""
    momenta, uniforms = draw_hmc(
        generator, num_warmup + num_samples, initial.shape[0], initial.shape[1], initial
    )
    return hmc_sample_from_draws(
        log_prob, initial, momenta, uniforms, num_warmup=num_warmup, num_leapfrog=num_leapfrog,
        initial_step_size=initial_step_size, target_accept=target_accept,
    )
