"""The work that the step's fixed parts need, counted from shapes, and the card's peaks.
Each product is counted once, as the mathematics needs it, whatever passes an
implementation makes: no implementation that meets the kernel's fp32 contract can read
more than 100% of these bounds.

Peaks: NVIDIA H100 SXM data sheet, dense TF32 495 TFLOP/s and HBM3 3.35 TB/s (at the
700 W power limit)."""

TF32_PEAK = 495e12  # FLOP/s
HBM_PEAK = 3.35e12  # bytes/s


def fused_predict_flops(N: int, n: int, D: int, P: int) -> float:
    """One fused prediction of ``N`` rows on ``n`` unmasked training points: distances
    ``2·N·n·D``, the mean ``2·N·n·P``, ``v = K·L⁻ᵀ`` with ``L⁻ᵀ`` triangular
    ``N·n(n+1)``, and the sums of squares ``2·N·n``."""
    return 2.0 * N * n * D + 2.0 * N * n * P + float(N) * n * (n + 1) + 2.0 * N * n


def fused_predict_bytes(N: int, n: int, D: int, P: int) -> float:
    """Each input read once (the rows ``[N, D]``, the training points ``[n, D]``, ``α
    [n, P]``, the triangle of ``L⁻ᵀ`` and two scalars) and each output written once (the
    mean ``[N, P]`` and the variance ``[N]``), in float32."""
    return 4.0 * (N * D + n * D + n * P + n * (n + 1) // 2 + 2 + N * P + N)


def fused_predict_least_s(N: int, n: int, D: int, P: int) -> float:
    """The least time the card could take for one launch."""
    return max(fused_predict_flops(N, n, D, P) / TF32_PEAK,
               fused_predict_bytes(N, n, D, P) / HBM_PEAK)


def lml_value_and_grad_flops(n: int, D: int) -> float:
    """One value and gradient of the log marginal likelihood on ``n`` points: the Gram's
    products ``2n²D``, the Cholesky ``n³/3``, two triangular solves ``2n²``, the inverse
    for the gradient ``2n³/3``, and its contraction with each of the ``D + 1`` kernel
    derivatives ``2n²``."""
    return 2.0 * n * n * D + n**3 / 3.0 + 2.0 * n * n + 2.0 * n**3 / 3.0 + 2.0 * n * n * (D + 1)


def cache_flops(n: int, D: int) -> float:
    """The posterior cache: the Gram, its Cholesky, the triangular inverse ``L⁻¹`` and
    ``α``."""
    return 2.0 * n * n * D + n**3 / 3.0 + n**3 / 3.0 + 2.0 * n * n


def marginal_flops(n: int, D: int, P: int = 1) -> float:
    """The marginal posterior at one point: cross-covariance, mean, triangular solve and
    its sum of squares."""
    return 2.0 * n * D + 2.0 * n * P + float(n) * n + 2.0 * n


def joint_flops(B: int, n: int, D: int, S: int) -> float:
    """The joint posterior of one batch of ``B`` points and ``S`` samples from it, as a
    Monte-Carlo batch rule takes it: the cross-covariance, the mean, the triangular solve,
    the batch covariance and its Cholesky, and the samples."""
    return (2.0 * B * n * D + 2.0 * B * n + float(B) * n * n + 2.0 * B * B * n
            + 2.0 * B * B * D + B**3 / 3.0 + 2.0 * B * B * S)


GRAD_FACTOR = 3.0  # a value and its gradient by reverse mode: the value and twice more


def step_flops(step, cell) -> float:
    """The fixed work of one step: the family's part, its fit after the tell and the
    posterior cache (``models/<builder>.py``'s ``flops``), and the rule's part, the seed
    pool's score and one value and gradient of the acquisition per optimisation run
    (``rules/<rule>.py``'s ``flops``). L-BFGS iterations are not counted, so the share
    this gives is a floor."""
    family = cell.family_module()
    fit, cache = family.flops(step, cell)
    pool, runs = cell.rule_module().flops(step, cell, family)
    return pool + fit + cache + runs
