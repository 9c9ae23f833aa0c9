"""Numerical building blocks: stationary kernels, masked linear algebra, batched
L-BFGS, Hamiltonian Monte Carlo, QMC sequences and the fused prediction kernel."""
from .hmc import HMCResults, hmc_sample
from .lbfgs import LBFGSResults, minimize_lbfgs, vmapped_minimize_lbfgs
from .linalg import add_jitter, cho_solve, masked_cholesky, masked_gram, solve_lower, solve_upper
from .qmc import halton_sample, sobol_sample

__all__ = [
    "HMCResults",
    "hmc_sample",
    "LBFGSResults",
    "minimize_lbfgs",
    "vmapped_minimize_lbfgs",
    "add_jitter",
    "masked_cholesky",
    "masked_gram",
    "solve_lower",
    "solve_upper",
    "cho_solve",
    "halton_sample",
    "sobol_sample",
]
