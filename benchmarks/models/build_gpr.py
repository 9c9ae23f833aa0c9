"""The family ``build_gpr`` on the program's side: the exact GP of
``trieste_tpu_torch.models.gp.build_gpr``, found by the name a configuration's
``model.builder`` gives. A family's file says how to build its model, what the check
judges, what a step of it costs, and what random draws its trajectories take:

- :func:`build`: the model as the configuration states it, given ``theta`` for a kept
  design (the Ask/Tell optimizer fits it where ``theta`` is ``None``);
- :func:`theta`: what the check judges, kept by reference before each ask and after each
  tell;
- :func:`flops`: the work of the fit and the cache after a tell;
- :func:`marginal_flops`, :func:`joint_flops`, :func:`trajectory_draw_flops` and
  :func:`trajectory_flops`: the work of the posterior a rule scores, under the names of
  the reference posterior's ``marginal``, ``joint`` and ``trajectory``;
- :func:`trajectory_draws`: the raw draws a trajectory takes from a generator;
- :data:`DEFAULTS`: the builder's defaults this family, and the configuration's copy of
  them that the reference reads, rely on.

The program is imported inside the functions, never when the module loads."""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from benchmarks.harness.spec import load_module

DEFAULTS = {
    "signal_noise_ratio": 10.0,
    "lengthscale_factor": 0.2,
    "prior_scale": 1.0,
    "squeeze_log_range": math.log(1000.0),
    "cholesky_jitter": 1e-5,  # float32's
    "num_kernel_samples": 10,
    "max_optimize_iters": 100,
    "num_rff_features": 1000,
}
"""``build_gpr``'s defaults that a configuration's ``model`` copies for the reference, or
that this file counts with (``num_rff_features``, the features of a trajectory)."""

_DF = {"matern12": 1, "matern32": 3, "matern52": 5}  # the spectral t's degrees of freedom


def build(cell, data, space, theta=None):
    """``build_gpr`` on ``data`` with the likelihood's variance the configuration fixes
    (or the default where it states none), not trainable; given ``theta``, with those
    hyperparameters."""
    from trieste_tpu_torch.models.gp import build_gpr

    model = build_gpr(data, space, trainable_likelihood=False,
                      likelihood_variance=cell.config["model"].get("likelihood_variance"))
    if theta is not None:
        model.params = theta
    return model


def theta(model):
    """The model's hyperparameters: its kernel, noise and mean constant."""
    return model.params


# -- the work of a step ----------------------------------------------------------------

def _counts():
    return load_module("metrics", "flops")


def flops(step, cell) -> Tuple[float, float]:
    """The fit's and the posterior cache's work after the step's tell: one value and
    gradient of the log marginal likelihood per restart, and the cache."""
    F = _counts()
    D, n_tell = int(cell.config["dimension"]), step.n + cell.num_query_points
    fit = int(cell.config["model"]["num_kernel_samples"]) * F.lml_value_and_grad_flops(n_tell, D)
    return fit, F.cache_flops(n_tell, D)


def marginal_flops(step, cell, rows: int, one_pass: bool = False) -> float:
    """The marginal posterior at ``rows`` points (the reference posterior's ``marginal``):
    per point the cross-covariance ``2nD``, the mean ``2n`` and the sum of squares ``2n``,
    and either a triangular solve ``n²`` or, with ``one_pass``, all rows in one pass that
    applies the stored ``L⁻ᵀ`` as a product, ``n(n+1)``."""
    F, D = _counts(), int(cell.config["dimension"])
    if one_pass:
        return F.fused_predict_flops(rows, step.n, D, 1)
    return float(rows) * F.marginal_flops(step.n, D, 1)


def joint_flops(step, cell, batch: int, samples: int) -> float:
    """The joint posterior of one batch of ``batch`` points and ``samples`` draws from it
    (the reference posterior's ``joint``)."""
    return _counts().joint_flops(batch, step.n, int(cell.config["dimension"]), samples)


def _features(cell) -> int:
    return int(cell.config["model"].get("num_rff_features", DEFAULTS["num_rff_features"]))


def trajectory_draw_flops(step, cell, slices: int) -> float:
    """The draw of ``slices`` trajectories' weights on ``n`` points with ``m`` features (the
    reference posterior's ``trajectory``, made once an ask): the features at the data
    ``2nmD``; where ``n ≤ m`` the Gram ``2n²m``, its Cholesky ``n³/3``, the residuals
    ``2Vnm``, two triangular solves ``2Vn²`` and the update ``2Vnm``; else the normal
    equations ``2nm²``, their Cholesky ``m³/3``, ``Φᵀy`` ``2nm``, the mean's two solves
    ``2m²`` and one solve a slice ``Vm²``."""
    D, n, m, V = int(cell.config["dimension"]), step.n, _features(cell), slices
    data = 2.0 * n * m * D
    if n <= m:
        return data + 2.0 * n * n * m + n**3 / 3.0 + 4.0 * V * n * m + 2.0 * V * n * n
    return data + 2.0 * n * m * m + m**3 / 3.0 + 2.0 * n * m + 2.0 * m * m + V * m * m


def trajectory_flops(step, cell, rows: int, slices: int) -> float:
    """``slices`` drawn trajectories, each at ``rows`` points: per point and slice the
    features ``2mD`` and the weights ``2m``."""
    m = _features(cell)
    return float(rows) * slices * (2.0 * m * int(cell.config["dimension"]) + 2.0 * m)


# -- the random draws of a trajectory --------------------------------------------------

def trajectory_draws(model, state: torch.Tensor, slices: int) -> Callable[[], Dict[str, Any]]:
    """The raw draws that ``model.trajectory_sampler()`` takes for ``slices`` trajectories
    from a generator in ``state``, in the order it takes them: the spectral normals
    ``[m, D]`` and, for a Matérn kernel, ``[m, df]``, the phases' uniforms ``[m]``, the
    prior weights ``[V, m]`` and, where the data's capacity ``C`` is at most ``m``, the
    noise normals ``[V, C]``. Read now from the model, which is about to be asked (host
    values only); drawn again when called, after the window, from a generator set to
    ``state``."""
    m, C, D = model.num_rff_features, *model.posterior_cache.X.shape
    kind = model.get_kernel().kind
    dtype, device = model.posterior_cache.X.dtype, model.posterior_cache.X.device
    state = state.clone()

    def draws() -> Dict[str, Optional[torch.Tensor]]:
        g = torch.Generator(device=device)
        g.set_state(state)
        normal = lambda *shape: torch.randn(shape, generator=g, dtype=dtype, device=device)  # noqa: E731
        out: Dict[str, Optional[torch.Tensor]] = {"frequency_normals": normal(m, D)}
        out["chi2_normals"] = normal(m, _DF[kind]) if kind in _DF else None
        out["phase_uniforms"] = torch.rand((m,), generator=g, dtype=dtype, device=device)
        out["prior_weights"] = normal(slices, m)
        out["noise_normals"] = normal(slices, C) if C <= m else None
        return out

    return draws
