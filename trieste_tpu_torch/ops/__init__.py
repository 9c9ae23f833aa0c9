"""Numerical building blocks: stationary kernels, masked linear algebra, batched
L-BFGS, Hamiltonian Monte Carlo and the fused prediction kernel."""
from .hmc import HMCResults, hmc_sample
