"""The port's public surface against the JAX package's: every name of the JAX ``__all__``
lists (the top level, ``ops``, ``models.gp``, ``parallel``), the version, the model
protocol's members, and the two linear-algebra helpers and the L-BFGS names that the
surface adds, held to the JAX functions in float64 on the CPU."""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trieste_tpu_torch
from trieste_tpu.models import interfaces as jint
from trieste_tpu.ops import lbfgs as jl
from trieste_tpu.ops import linalg as jla
from trieste_tpu_torch.models import interfaces as tint
from trieste_tpu_torch.ops import linalg as tla

F64 = torch.float64
TOL = dict(rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("module", ["", ".ops", ".models.gp", ".parallel"])
def test_every_name_of_the_jax_all_lists_is_in_the_port(module):
    jax_module = importlib.import_module("trieste_tpu" + module)
    port = importlib.import_module("trieste_tpu_torch" + module)
    missing = [name for name in jax_module.__all__ if not hasattr(port, name)]
    assert missing == []
    assert set(jax_module.__all__) <= set(port.__all__)


def test_top_level_version_and_modules():
    from trieste_tpu_torch import version

    assert trieste_tpu_torch.__version__ == version.VERSION == "0.3.0"
    assert trieste_tpu_torch.profiling is importlib.import_module("trieste_tpu_torch.profiling")
    # the JAX package's stale top-level version is a fault of the reference (ROADMAP)
    assert importlib.import_module("trieste_tpu.version").VERSION == trieste_tpu_torch.__version__


def test_reexports_are_the_submodules_objects():
    from trieste_tpu_torch import ops
    from trieste_tpu_torch.models import gp
    from trieste_tpu_torch.models.gp import priors, sampler, sparse, training
    from trieste_tpu_torch.ops import lbfgs

    assert gp.fit_gpr is training.fit_gpr and gp.fit_svgp_minibatch is sparse.fit_svgp_minibatch
    assert gp.default_priors is priors.default_priors
    assert gp.log_prior_density is priors.log_prior_density
    assert gp.DecoupledTrajectorySampler is sampler.DecoupledTrajectorySampler
    assert ops.vmapped_minimize_lbfgs is ops.minimize_lbfgs is lbfgs.minimize_lbfgs
    assert ops.add_jitter is tla.add_jitter


class _PredictOnly:
    def predict(self, query_points):
        return query_points, query_points


def test_a_predict_only_class_is_no_model_in_either_package():
    assert not isinstance(_PredictOnly(), jint.ProbabilisticModel)
    assert not isinstance(_PredictOnly(), tint.ProbabilisticModel)


def test_every_port_model_is_a_model_but_the_top_fidelity_view():
    """Each port class with ``predict`` has ``sample`` and ``log``, but the multifidelity
    top-fidelity view, which lacks ``log`` in both packages."""
    from trieste_tpu.acquisition.function import entropy as jentropy
    from trieste_tpu_torch.acquisition.function import entropy, greedy_batch
    from trieste_tpu_torch.models import encoders
    from trieste_tpu_torch.models.deepgp import deep_gp
    from trieste_tpu_torch.models.ensembles import deep_ensemble
    from trieste_tpu_torch.models.gp import gpr, mcmc, multifidelity, sparse, vgp

    models = [
        greedy_batch._FantasizedModel, deep_gp.DeepGaussianProcess,
        encoders.EncodedProbabilisticModel, encoders.EncodedTrainableProbabilisticModel,
        deep_ensemble.DeepEnsemble, gpr.GaussianProcessRegression,
        mcmc.GaussianProcessRegressionMCMC, multifidelity.MultifidelityAutoregressive,
        multifidelity.MultifidelityNonlinearAutoregressive,
        sparse.SparseGaussianProcessRegression, sparse.SparseVariational,
        vgp.VariationalGaussianProcess, tint.ModelStack, tint.TrainableModelStack,
        tint.PredictJointModelStack, tint.PredictYModelStack,
        tint.TrainablePredictJointModelStack, tint.HasReparamSamplerModelStack,
    ]
    assert [m.__name__ for m in models if not issubclass(m, tint.ProbabilisticModel)] == []
    assert not issubclass(entropy._TopFidelityView, tint.ProbabilisticModel)
    assert not issubclass(jentropy._TopFidelityView, jint.ProbabilisticModel)

    from trieste_tpu_torch.data import Dataset
    from trieste_tpu_torch.models.gp import build_gpr
    from trieste_tpu_torch.space import Box

    X = torch.as_tensor(np.random.default_rng(0).uniform(size=(6, 2)))
    ds = Dataset.from_arrays(X, torch.sum(X**2, -1, keepdim=True))
    model = build_gpr(ds, Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu"))
    assert isinstance(model, tint.TrainableProbabilisticModel)


@pytest.mark.parametrize("jitter", [None, 0.25])
def test_add_jitter_matches_jax(jitter):
    K = np.random.default_rng(1).normal(size=(3, 4, 4))
    np.testing.assert_allclose(
        tla.add_jitter(torch.as_tensor(K), jitter).numpy(),
        np.asarray(jla.add_jitter(jnp.asarray(K), jitter)), **TOL,
    )


def test_add_jitter_default_scales_with_dtype():
    from trieste_tpu_torch.utils.misc import jitter_for

    j32 = float(tla.add_jitter(torch.zeros(2, 2, dtype=torch.float32))[0, 0])
    j64 = float(tla.add_jitter(torch.zeros(2, 2, dtype=F64))[0, 0])
    assert j32 == pytest.approx(jitter_for(torch.float32))
    assert j64 == pytest.approx(jitter_for(F64))
    assert j32 > j64
    assert float(tla.add_jitter(torch.zeros(2, 2, dtype=F64))[0, 1]) == 0.0


def test_masked_logdet_from_chol_matches_jax_and_counts_only_valid_rows():
    A = np.random.default_rng(2).normal(size=(5, 5))
    K = A @ A.T + 5.0 * np.eye(5)
    mask = np.array([True, True, True, False, False])
    L = tla.masked_cholesky(torch.as_tensor(K), torch.as_tensor(mask), jitter=0.0)
    got = tla.masked_logdet_from_chol(L, torch.as_tensor(mask))
    jL = jla.masked_cholesky(jnp.asarray(K), jnp.asarray(mask), jitter=0.0)
    np.testing.assert_allclose(float(got), float(jla.masked_logdet_from_chol(jL, mask)), **TOL)
    np.testing.assert_allclose(float(got), np.linalg.slogdet(K[:3, :3])[1], rtol=1e-10)


@pytest.mark.parametrize("n", [1, 20])
def test_the_batched_lbfgs_runs_the_jax_single_start_form(n):
    """The JAX ``minimize_lbfgs(f, x0 [n])`` is the port's batch of one run, as the port's
    docstring writes it."""
    from trieste_tpu_torch.ops import vmapped_minimize_lbfgs

    target = np.arange(n, dtype=np.float64) + 3.0 * (n == 1)
    jres = jl.minimize_lbfgs(lambda x: jnp.sum((x - target) ** 2), jnp.zeros(n), max_iters=100)
    f = lambda x: torch.sum((x - torch.as_tensor(target)) ** 2)  # noqa: E731
    tres = vmapped_minimize_lbfgs(torch.vmap(f), torch.zeros(1, n, dtype=F64),
                                  max_iters=100)
    np.testing.assert_allclose(tres.x[0].numpy(), np.asarray(jres.x), atol=1e-6)
    np.testing.assert_allclose(tres.x[0].numpy(), target, atol=1e-5)
