"""Numerical building blocks: stationary kernels, masked linear algebra, batched
L-BFGS and the fused prediction kernel."""
