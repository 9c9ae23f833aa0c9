"""The port's deep models on the CPU, against the JAX package in float64: the deep ensemble
(its stacked MLP, loss, moments, samples, fit and trajectories) and the doubly-stochastic
deep GP (layer moments, propagation, ELBO, fit and trajectories).

The packages cannot share random draws, so each test rebuilds the JAX draws from their keys
with the splits the JAX code makes and feeds them to the port's pure halves: the bootstrap
(``k_boot, _ = split(key)``, ``categorical`` over ``[E, C]``), a sample's member indices
and head noise (``split(key)`` into ``(k_idx, k_eps)``), a trajectory's (the same split),
and the deep GP's propagation noise (``split(key, num_layers)``, one normal ``[S, N,
d_out]`` per layer, side by side in the port's ``[S, N, W]``; a fit's step t takes key t of
``split(key, num_steps)``; a trajectory's column b propagates alone, ``S = 1``, from key
b). Tolerances: the network, loss, moments, samples, layer moments, propagation, ELBO and
trajectories at rtol 1e-9 (the same arithmetic); a 50-step ensemble fit and a 30-step deep
GP fit at rtol 1e-6 (Adam's steps amplify rounding); the analytic contracts of the JAX
package's ``test_deep_ensemble_contracts.py`` and ``test_dgp_contracts.py`` at theirs; the
slice, two EGO steps of PCTS over 4 points through ``BayesianOptimizer.optimize`` with each
model, at atol 1e-6 on the query points.

Every JAX function is compiled whole.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trieste_tpu as jt
from trieste_tpu import space as jsp
from trieste_tpu.acquisition import optimizer as jopt
from trieste_tpu.acquisition import rule as jrule
from trieste_tpu.acquisition.function import continuous_thompson_sampling as jcts
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models.deepgp import deep_gp as jdgp
from trieste_tpu.models.ensembles import deep_ensemble as jde
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu_torch import BayesianOptimizer, Dataset, convert
from trieste_tpu_torch import space as tsp
from trieste_tpu_torch.acquisition import optimizer as topt
from trieste_tpu_torch.acquisition import rule as trule
from trieste_tpu_torch.acquisition.function.continuous_thompson_sampling import (
    ParallelContinuousThompsonSampling,
)
from trieste_tpu_torch.models import deepgp, ensembles
from trieste_tpu_torch.models.deepgp import deep_gp as tdgp
from trieste_tpu_torch.models.ensembles import deep_ensemble as tde
from trieste_tpu_torch.models.gp import posterior as tpost
from trieste_tpu_torch.models.gp import inducing_points as tind
from trieste_tpu_torch.ops.kernels import gram, stationary

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-9  # the same arithmetic in both packages
FIT_RTOL = 1e-6


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=F64)


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module", autouse=True)
def quick_jax_compiles():
    """XLA's optimizations off while this module runs: compiling dominates the JAX side's
    time, and the results agree to the same tolerances."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _data(n=12, d=2, seed=0, capacity=16):
    """``n`` points of a smooth function in ``[0, 1]^d``, in both packages."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    Y = np.sum(np.square(X - 0.4), axis=-1, keepdims=True) + 0.1 * np.sin(5 * X[:, :1])
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y), capacity=capacity)
    tds = Dataset.from_arrays(_t(X), _t(Y), capacity=capacity)
    return jds, tds


# -- the deep ensemble ---------------------------------------------------------------------


def _ensemble_from_jax(jparams) -> tde.DeepEnsembleParams:
    return convert.deep_ensemble_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams.member_params),
        np.asarray(jparams.x_mean), np.asarray(jparams.x_std),
        np.asarray(jparams.y_mean), np.asarray(jparams.y_std), device="cpu",
    )


def _in_float64(jmodel):
    """The JAX ensemble with float64 weights: flax makes them float32 under x64 (computing
    in float64), and Adam would round every step to float32."""
    p = jmodel.params
    jmodel._params = p.replace(member_params=jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64), p.member_params))
    return jmodel


@pytest.fixture(scope="module")
def ensemble_pair():
    """A JAX ensemble of 3 members with hidden units (8, 6), trained 20 steps so that the
    normalization is not the identity, and its port through ``convert``."""
    jds, tds = _data()
    jmodel = _in_float64(jde.build_deep_ensemble(jds, ensemble_size=3, hidden_units=(8, 6),
                                                 num_train_steps=20, key=jax.random.PRNGKey(4)))
    jmodel.optimize(jds)
    return jmodel, _ensemble_from_jax(jmodel.params), jds, tds


_jit_member_predict = jax.jit(jde.ensemble_member_predict, static_argnums=0)
_jit_ensemble_predict = jax.jit(jde.ensemble_predict, static_argnums=0)


def test_gaussian_mlp_and_the_moments_match_jax(ensemble_pair):
    """The stacked network in flax's layout, each member's moments and the mixture's, at a
    ``[2, 5, D]`` input (leading dims kept)."""
    jmodel, params, _, _ = ensemble_pair
    x = np.random.default_rng(1).uniform(size=(2, 5, 2))
    network = jmodel._network
    jp = jmodel.params
    want_mean, want_var = jax.vmap(lambda p: network.apply({"params": p}, jnp.asarray(x[0])))(
        jp.member_params)
    got_mean, got_var = params.member_params(_t(x[0]))
    _close(got_mean, want_mean)
    _close(got_var, want_var)
    for got, want in zip(tde.ensemble_member_predict(params, _t(x)),
                         _jit_member_predict(network, jp, jnp.asarray(x))):
        assert got.shape == want.shape == (3, 2, 5, 1)
        _close(got, want)
    for got, want in zip(tde.ensemble_predict(params, _t(x)),
                         _jit_ensemble_predict(network, jp, jnp.asarray(x))):
        _close(got, want)
    assert params.member_params.hidden_units == (8, 6) and params.member_params.ensemble_size == 3


def test_nll_loss_with_masking_matches_jax():
    rng = np.random.default_rng(2)
    mean, y = rng.normal(size=(3, 6, 2)), rng.normal(size=(6, 2))
    var = rng.uniform(0.1, 2.0, size=(3, 6, 2))
    w = rng.integers(0, 3, size=(3, 6)).astype(float)
    w[:, -2:] = 0.0
    want = jax.vmap(jde._nll_loss, in_axes=(0, 0, None, 0))(mean, var, y, w)
    _close(tde._nll_loss(_t(mean), _t(var), _t(y), _t(w)), want)
    _close(tde._nll_loss(_t(mean), _t(var), _t(y), _t(np.zeros((3, 6)))), np.zeros(3))


def test_sample_and_sample_ensemble_given_the_jax_draws(ensemble_pair):
    jmodel, params, _, tds = ensemble_pair
    x = np.random.default_rng(3).uniform(size=(4, 2))
    key = jax.random.PRNGKey(9)
    want = jmodel.sample(key, jnp.asarray(x), 6)
    k_idx, k_eps = jax.random.split(key)
    index = jax.random.randint(k_idx, (6,), 0, 3)
    eps = jax.random.normal(k_eps, (6, 4, 1), jnp.float64)
    model = tde.DeepEnsemble(params, tds)
    means, vars_ = model.predict_ensemble(_t(x))
    _close(tde.sample_from_draws(means, vars_, torch.as_tensor(np.array(index)), _t(eps)), want)
    want = jmodel.sample_ensemble(key, jnp.asarray(x), 5)
    index = torch.as_tensor(np.array(jax.random.randint(key, (5,), 0, 3)))
    _close(means[index], want)
    draws = model.sample(torch.Generator().manual_seed(0), _t(x), 7)
    assert draws.shape == (7, 4, 1) and draws.dtype == F64


@pytest.mark.parametrize("diversify", [False, True])
def test_the_ensemble_trajectory_given_the_jax_draws(ensemble_pair, diversify):
    jmodel, params, _, tds = ensemble_pair
    key = jax.random.PRNGKey(11)
    jtraj = jde.DeepEnsembleTrajectorySampler(jmodel, diversify=diversify).get_trajectory(key, 3)
    k_idx, k_eps = jax.random.split(key)
    np.testing.assert_array_equal(jtraj.indices, jax.random.randint(k_idx, (3,), 0, 3))
    if diversify:
        np.testing.assert_array_equal(jtraj.eps, jax.random.normal(k_eps, (3, 1)))
    traj = tde._EnsembleTrajectory(params, torch.as_tensor(np.array(jtraj.indices)),
                                   _t(jtraj.eps))
    x = np.random.default_rng(5).uniform(size=(7, 3, 2))
    want = jax.jit(lambda t, x: t(x))(jtraj, jnp.asarray(x))
    got = traj(_t(x))
    assert got.shape == (7, 3, 1)
    _close(got, want)
    port = tde.DeepEnsembleTrajectorySampler(tde.DeepEnsemble(params, tds), diversify)
    drawn = port.get_trajectory(torch.Generator().manual_seed(0), 3)
    assert bool(drawn.eps.any()) == diversify and drawn(_t(x)).shape == (7, 3, 1)


@partial(jax.jit, static_argnums=(1, 2))
def _jax_bootstrap(key, E, C, mask):
    """The indices ``fit_deep_ensemble`` draws from its key."""
    k_boot, _ = jax.random.split(key)
    m = mask.astype(jnp.float64)
    probs = m / jnp.maximum(jnp.sum(m), 1.0)
    return jax.random.categorical(k_boot, jnp.log(jnp.maximum(probs, 1e-12)), shape=(E, C))


@pytest.mark.parametrize("bootstrap", [True, False])
def test_fit_deep_ensemble_matches_jax_on_the_replayed_bootstrap(ensemble_pair, bootstrap):
    jmodel, _, jds, tds = ensemble_pair
    init = _in_float64(jde.build_deep_ensemble(jds, ensemble_size=3, hidden_units=(8, 6),
                                               key=jax.random.PRNGKey(6)))
    key = jax.random.PRNGKey(7)
    want = jde.fit_deep_ensemble(key, init._network, init.params, jds.query_points,
                                 jds.observations, jds.mask, ensemble_size=3, num_steps=50,
                                 bootstrap=bootstrap)
    indices = None
    if bootstrap:
        indices = torch.as_tensor(np.array(_jax_bootstrap(key, 3, jds.capacity, jds.mask)))
        assert bool((indices < len(tds)).all())
    got = tde.fit_deep_ensemble_from_indices(
        indices, _ensemble_from_jax(init.params), tds.query_points, tds.observations, tds.mask,
        num_steps=50,
    )
    _close(got.loss, want.loss, rtol=FIT_RTOL)
    assert int(got.num_nonfinite) == 0
    ref = _ensemble_from_jax(want.params)
    for a, b in zip(got.params.member_params.parameters(), ref.member_params.parameters()):
        _close(a, b, rtol=FIT_RTOL, atol=1e-9)
        assert not a.requires_grad
    for name in ("x_mean", "x_std", "y_mean", "y_std"):
        _close(getattr(got.params, name), getattr(ref, name))


def test_bootstrap_draws_only_valid_rows_and_counts_them():
    mask = torch.arange(16) < 11
    idx = tde.bootstrap_indices(torch.Generator().manual_seed(0), mask, 4)
    assert idx.shape == (4, 16) and bool((idx < 11).all())
    none_valid = tde.bootstrap_indices(torch.Generator().manual_seed(0), torch.zeros(8, dtype=torch.bool), 2)
    assert none_valid.shape == (2, 8)


def test_builder_errors_init_distribution_and_alias():
    _, tds = _data(n=30, capacity=32)
    with pytest.raises(ValueError, match="ensemble_size"):
        tde.build_deep_ensemble(tds, ensemble_size=1)
    with pytest.raises(ValueError, match="hidden layer"):
        tde.build_deep_ensemble(tds, hidden_units=())
    assert ensembles.build_keras_ensemble is tde.build_deep_ensemble
    model = tde.build_deep_ensemble(tds, ensemble_size=4, hidden_units=(400, 300))
    kernels = list(model.params.member_params.kernels)
    assert [tuple(k.shape) for k in kernels] == [(4, 2, 400), (4, 400, 300), (4, 300, 1), (4, 300, 1)]
    big = kernels[1]  # 480,000 draws: LeCun's variance 1/fan_in, cut at two of its deviations
    std = math.sqrt(1 / 400) / tde.TRUNCATED_NORMAL_STD
    assert abs(float(big.var()) * 400 - 1.0) < 0.01
    assert float(big.abs().max()) <= 2 * std
    assert all(float(b.abs().max()) == 0.0 for b in model.params.member_params.biases)
    assert model.num_networks == model.ensemble_size == 4 and repr(model) == "DeepEnsemble(E=4)"


# -- the deep ensemble's contracts (tests/unit/test_deep_ensemble_contracts.py) --------------


def _sine_data(n=60, seed=0, noise=0.05):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, size=(n, 1))
    f = np.sin(3.0 * X)
    return Dataset.from_arrays(_t(X), _t(f + noise * rng.normal(size=f.shape))), f


@pytest.fixture(scope="module")
def trained_ensemble():
    ds, _ = _sine_data()
    model = tde.build_deep_ensemble(ds, ensemble_size=5, num_train_steps=800)
    model.optimize(ds)
    return model, ds


def test_mixture_fusion_identity_and_predict_y(trained_ensemble):
    model, _ = trained_ensemble
    x = torch.linspace(-1.0, 1.0, 17, dtype=F64)[:, None]
    mean, var = model.predict(x)
    means, vars_ = model.predict_ensemble(x)
    mix_mean = means.mean(0)
    mix_var = (vars_ + means**2).mean(0) - mix_mean**2
    _close(mean, mix_mean, rtol=1e-6, atol=1e-8)
    _close(var, torch.clamp_min(mix_var, 1e-12), rtol=1e-6, atol=1e-8)
    assert bool((var >= vars_.mean(0) - 1e-9).all())
    mean_y, var_y = model.predict_y(x)
    _close(mean_y, mean, atol=1e-9)
    _close(var_y, var, atol=1e-9)


def test_known_gaussian_recovery_and_epistemic_growth(trained_ensemble):
    model, _ = trained_ensemble
    x = torch.linspace(-0.9, 0.9, 25, dtype=F64)[:, None]
    mean, var = model.predict(x)
    assert float((mean - torch.sin(3.0 * x)).abs().max()) < 0.15
    assert float(var.min()) > 2.5e-4 and float(var.max()) < 0.25
    _, var_in = model.predict(torch.zeros(1, 1, dtype=F64))
    _, var_out = model.predict(torch.full((1, 1), 2.5, dtype=F64))
    assert float(var_out[0, 0]) > 2.0 * float(var_in[0, 0])


def test_nll_loss_analytic_value():
    mean = _t([[0.0], [1.0], [5.0]])
    var = _t([[1.0], [4.0], [1.0]])
    y = _t([[1.0], [1.0], [0.0]])
    w = _t([1.0, 2.0, 0.0])
    nll0 = 0.5 * (np.log(2 * np.pi * 1.0) + 1.0)
    nll1 = 0.5 * (np.log(2 * np.pi * 4.0) + 0.0)
    _close(tde._nll_loss(mean, var, y, w), (nll0 + 2.0 * nll1) / 3.0, rtol=1e-6)


def test_bootstrap_members_end_distinct():
    ds, _ = _sine_data(n=30)
    model = tde.build_deep_ensemble(ds, ensemble_size=3, num_train_steps=200)
    model.optimize(ds)
    assert any(not torch.allclose(p[0], p[1]) or not torch.allclose(p[1], p[2])
               for p in model.params.member_params.parameters())


def test_sample_moments_match_predict(trained_ensemble):
    model, _ = trained_ensemble
    x = _t([[0.3], [-0.5]])
    samples = model.sample(torch.Generator().manual_seed(9), x, 4000)
    mean, var = model.predict(x)
    _close(samples.mean(0), mean, rtol=0, atol=0.05)
    _close(samples.var(0, correction=0), var, rtol=0.25, atol=5e-3)


def test_masked_rows_do_not_affect_the_ensemble_fit():
    ds, _ = _sine_data(n=24)
    X, Y = ds.trimmed_query_points, ds.trimmed_observations
    padded = Dataset.from_arrays(X, Y, capacity=40)
    qp, obs = padded.query_points.clone(), padded.observations.clone()
    qp[24:], obs[24:] = 1e6, -1e6
    poisoned = Dataset(qp, obs, 24)
    network = tde.init_gaussian_mlp(torch.Generator().manual_seed(3), 3, 1, (32, 32), 1,
                                    dtype=F64, device=torch.device("cpu"))
    params = tde.DeepEnsembleParams(network, _t([0.0]), _t([1.0]), _t([0.0]), _t([1.0]))

    def fit(data):
        return tde.fit_deep_ensemble(torch.Generator().manual_seed(5), params, data.query_points,
                                     data.observations, data.mask, num_steps=150, bootstrap=False)

    r_trim, r_pad = fit(Dataset.from_arrays(X, Y, capacity=24)), fit(poisoned)
    _close(r_trim.loss, r_pad.loss, rtol=1e-5)
    x = _t([[0.2], [-0.7]])
    m1, v1 = tde.ensemble_predict(r_trim.params, x)
    m2, v2 = tde.ensemble_predict(r_pad.params, x)
    _close(m1, m2, rtol=1e-4, atol=1e-6)
    _close(v1, v2, rtol=1e-3, atol=1e-6)
    assert all(not p.requires_grad for p in params.member_params.parameters())


# -- the deep GP ---------------------------------------------------------------------------


def _dgp_from_jax(jparams) -> tdgp.DGPParams:
    return convert.dgp_params_from_numpy(
        [dict(kind=l.kernel.kind, variance=np.asarray(l.kernel.variance),
              lengthscales=np.asarray(l.kernel.lengthscales),
              inducing_points=np.asarray(l.inducing_points), q_mu=np.asarray(l.q_mu),
              q_sqrt=np.asarray(l.q_sqrt)) for l in jparams.layers],
        np.asarray(jparams.noise_variance), np.asarray(jparams.mean_constant), device="cpu",
    )


def _random_dgp(seed=0, D=2, M=6, width=3):
    """A two-layer JAX DGP with non-trivial q (``q_sqrt`` a full matrix: the port must use
    its lower triangle) and a Matérn outer kernel."""
    rng = np.random.default_rng(seed)

    def layer(kind, d_in, d_out, var):
        return jdgp.DGPLayerParams(
            kernel=jstationary(kind, var, rng.uniform(0.3, 0.9, size=d_in)),
            inducing_points=jnp.asarray(rng.uniform(size=(M, d_in))),
            q_mu=jnp.asarray(rng.normal(size=(M, d_out))),
            q_sqrt=jnp.asarray(0.3 * rng.normal(size=(d_out, M, M))),
        )

    return jdgp.DGPParams(
        layers=(layer("rbf", D, width, 0.7), layer("matern52", width, 1, 1.2)),
        noise_variance=jnp.asarray(0.03), mean_constant=jnp.asarray(0.4),
    )


@partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_noise(key, S, N, d_outs):
    """The normals ``dgp_propagate_samples`` draws from ``key``, side by side."""
    keys = jax.random.split(key, len(d_outs))
    return jnp.concatenate(
        [jax.random.normal(keys[i], (S, N, d), jnp.float64) for i, d in enumerate(d_outs)], axis=-1
    )


def _d_outs(jparams):
    return tuple(int(l.q_mu.shape[-1]) for l in jparams.layers)


def test_layer_moments_match_jax():
    jparams = _random_dgp()
    params = _dgp_from_jax(jparams)
    x = np.random.default_rng(1).uniform(size=(9, 2))
    for jl, tl, xin in ((jparams.layers[0], params.layers[0], x),
                        (jparams.layers[1], params.layers[1], np.c_[x, x[:, :1]])):
        want = jax.jit(jdgp._layer_moments)(jl, jnp.asarray(xin))
        for got, w in zip(tdgp._layer_moments(tl, _t(xin)), want):
            _close(got, w)
    # one input per sample, as the later layers take them
    xs = np.random.default_rng(2).uniform(size=(4, 9, 3))
    want = jax.jit(jax.vmap(jdgp._layer_moments, in_axes=(None, 0)))(jparams.layers[1], jnp.asarray(xs))
    for got, w in zip(tdgp._layer_moments(params.layers[1], _t(xs)), want):
        _close(got, w)


def test_identity_mean_pads_and_cuts():
    x = _t(np.arange(6.0).reshape(3, 2))
    for d_out in (1, 2, 4):
        _close(tdgp._identity_mean(x, d_out), jdgp._identity_mean(jnp.asarray(np.asarray(x)), d_out))


def test_propagation_and_elbo_given_the_jax_noise(monkeypatch):
    jparams = _random_dgp()
    params = _dgp_from_jax(jparams)
    jds, tds = _data(n=11, capacity=16)
    key = jax.random.PRNGKey(3)
    noise = _t(_jax_noise(key, 5, 16, _d_outs(jparams)))
    want = jax.jit(jdgp.dgp_propagate_samples, static_argnums=3)(key, jparams, jds.query_points, 5)
    got = tdgp.dgp_propagate_from_noise(params, tds.query_points, noise)
    assert got.shape == (5, 16, 1)
    _close(got, want)
    # chunks of samples give the same paths
    monkeypatch.setattr(tdgp, "PROPAGATE_CHUNK_BYTES", 16 * (3 + 2) * 6 * 8 * 2)
    assert tdgp._sample_chunk(params, 5, 16, 8) == 2
    _close(tdgp.dgp_propagate_from_noise(params, tds.query_points, noise), want)
    monkeypatch.undo()
    want = jax.jit(jdgp.dgp_elbo, static_argnums=5)(key, jparams, jds.query_points,
                                                     jds.observations, jds.mask, 5)
    _close(tdgp.dgp_elbo_from_noise(params, tds.query_points, tds.observations, tds.mask, noise), want)


def test_the_dgp_trajectory_given_the_jax_draws():
    jparams = _random_dgp(seed=1)
    params = _dgp_from_jax(jparams)
    jmodel = jdgp.DeepGaussianProcess(jparams, _data()[0])
    jtraj = jmodel.trajectory_sampler().get_trajectory(jax.random.PRNGKey(5), 3)
    x = np.random.default_rng(4).uniform(size=(8, 3, 2))
    want = jax.jit(lambda t, x: t(x))(jtraj, jnp.asarray(x))
    noise = np.stack([np.asarray(_jax_noise(k, 1, 8, _d_outs(jparams)))[0] for k in jtraj.keys])
    got = tdgp.dgp_trajectory_from_noise(params, _t(x), _t(noise))
    assert got.shape == (8, 3, 1)
    _close(got, want)
    # the port's own trajectory: a fixed function of its input, drawn afresh per seed
    model = tdgp.DeepGaussianProcess(params, _data()[1])
    traj = model.trajectory_sampler().get_trajectory(torch.Generator().manual_seed(0), 3)
    _close(traj(_t(x)), traj(_t(x)), rtol=0, atol=0)
    other = model.trajectory_sampler().get_trajectory(torch.Generator().manual_seed(1), 3)
    assert not torch.allclose(traj(_t(x)), other(_t(x)))


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_fit_noise(key, T, S, N, d_outs):
    """Each step's propagation noise in ``fit_dgp``: ``[T, S, N, W]``."""
    return jax.vmap(lambda k: _jax_noise(k, S, N, d_outs))(jax.random.split(key, T))


def test_fit_dgp_matches_jax_on_the_replayed_noise():
    jparams = _random_dgp(seed=2)
    jds, tds = _data(n=10, capacity=16)
    key = jax.random.PRNGKey(8)
    want = jdgp.fit_dgp(key, jparams, jds.query_points, jds.observations, jds.mask,
                        num_steps=30, learning_rate=0.01)
    noise = _t(_jax_fit_noise(key, 30, 8, 16, _d_outs(jparams)))
    got = tdgp.fit_dgp_from_noise(noise, _dgp_from_jax(jparams), tds.query_points,
                                  tds.observations, tds.mask, learning_rate=0.01)
    _close(got.loss, want.loss, rtol=FIT_RTOL)
    assert int(got.num_nonfinite) == 0
    ref = _dgp_from_jax(want.params)
    for a, b in zip(got.params.layers, ref.layers):
        for name in ("inducing_points", "q_mu", "q_sqrt"):
            _close(getattr(a, name), getattr(b, name), rtol=FIT_RTOL, atol=1e-9)
        _close(a.kernel.variance, b.kernel.variance, rtol=FIT_RTOL)
        _close(a.kernel.lengthscales, b.kernel.lengthscales, rtol=FIT_RTOL)
    _close(got.params.noise_variance, ref.noise_variance, rtol=FIT_RTOL)
    _close(got.params.mean_constant, ref.mean_constant, rtol=FIT_RTOL)


def test_fit_dgp_draws_its_noise_in_blocks_under_the_cap(monkeypatch):
    """Under a cap of three steps' noise, 10 steps draw blocks of 3, 3, 3 and 1 steps, each
    drawn when the previous one is spent; the fit is the one on those blocks end to end."""
    params = _dgp_from_jax(_random_dgp(seed=2))
    _, tds = _data(n=10, capacity=16)
    step_bytes = 8 * 16 * params.noise_width * 8
    monkeypatch.setattr(tdgp, "FIT_NOISE_BLOCK_BYTES", 3 * step_bytes + step_bytes // 2)
    drawn = []
    draw = tdgp.draw_noise
    monkeypatch.setattr(tdgp, "draw_noise", lambda *a: drawn.append(draw(*a)) or drawn[-1])
    got = tdgp.fit_dgp(torch.Generator().manual_seed(3), params, tds.query_points,
                       tds.observations, tds.mask, num_steps=10)
    assert [b.shape[:2] for b in drawn] == [(3, 8), (3, 8), (3, 8), (1, 8)]
    assert max(b.numel() * b.element_size() for b in drawn) <= tdgp.FIT_NOISE_BLOCK_BYTES
    want = tdgp.fit_dgp_from_noise(torch.cat(drawn), params, tds.query_points,
                                   tds.observations, tds.mask)
    _close(got.loss, want.loss, rtol=0, atol=0)
    for a, b in zip(got.params.layers, want.params.layers):
        _close(a.q_sqrt, b.q_sqrt, rtol=0, atol=0)


def test_build_vanilla_deep_gp_matches_jax_given_the_inducing_points(monkeypatch):
    """Three layers at width 3 over 2-D inputs (so an inner layer pads its inducing points),
    with the JAX builder's k-means points."""
    jds, tds = _data(n=12, capacity=16)
    jspace = jsp.Box([0.0, -1.0], [1.0, 2.0])
    tspace = tsp.Box([0.0, -1.0], [1.0, 2.0], dtype=F64, device="cpu")
    jmodel = jdgp.build_vanilla_deep_gp(jds, jspace, num_layers=3, num_inducing_points=5,
                                        inner_layer_width=3)
    Z0 = _t(jmodel.params.layers[0].inducing_points)
    monkeypatch.setattr(tind.KMeansInducingPointSelector, "_recalculate_inducing_points",
                        lambda self, M, model, dataset: Z0)
    model = deepgp.build_vanilla_deep_gp(tds, tspace, num_layers=3, num_inducing_points=5,
                                         inner_layer_width=3)
    want = _dgp_from_jax(jmodel.params)
    for a, b in zip(model.params.layers, want.layers):
        for name in ("inducing_points", "q_mu", "q_sqrt"):
            _close(getattr(a, name), getattr(b, name))
        _close(a.kernel.variance, b.kernel.variance)
        _close(a.kernel.lengthscales, b.kernel.lengthscales)
        assert a.kernel.kind == b.kernel.kind
    _close(model.params.noise_variance, want.noise_variance)
    _close(model.params.mean_constant, want.mean_constant)
    assert repr(model) == "DeepGaussianProcess(L=3)"
    with pytest.raises(ValueError, match="num_layers"):
        deepgp.build_vanilla_deep_gp(tds, tspace, num_layers=0)


def test_convert_carries_both_models_across():
    jds, tds = _data(n=9, capacity=16)
    jmodel = jde.build_deep_ensemble(jds, ensemble_size=2, hidden_units=(5,), key=jax.random.PRNGKey(1))
    params = _ensemble_from_jax(jmodel.params)
    x = np.random.default_rng(6).uniform(size=(4, 2))
    for got, want in zip(tde.ensemble_predict(params, _t(x)), jmodel.predict(jnp.asarray(x))):
        _close(got, want)
    assert [tuple(k.shape) for k in params.member_params.kernels] == [(2, 2, 5), (2, 5, 1), (2, 5, 1)]
    jparams = _random_dgp(seed=3)
    dparams = _dgp_from_jax(jparams)
    assert dparams.noise_width == 4 and dparams.layers[1].kernel.kind == "matern52"
    _close(dparams.layers[0].q_sqrt, jparams.layers[0].q_sqrt, rtol=0, atol=0)
    assert convert.dgp_params_from_numpy(
        [dict(kind="rbf", variance=1.0, lengthscales=[1.0], inducing_points=np.zeros((2, 1)),
              q_mu=np.zeros((2, 1)), q_sqrt=np.zeros((1, 2, 2)))], 0.1, 0.0, device="cpu",
        dtype=torch.float32,
    ).mean_constant.dtype == torch.float32


def test_dgp_predict_is_the_moments_of_the_seed_7_paths(monkeypatch):
    """``predict`` on the JAX paths of ``PRNGKey(7)`` matches JAX at rtol 1e-9; the port's own
    surface is deterministic, keeps leading dims, and ``predict_y`` adds the noise."""
    jparams = _random_dgp(seed=4)
    params = _dgp_from_jax(jparams)
    jds, tds = _data()
    jmodel = jdgp.DeepGaussianProcess(jparams, jds, num_predict_samples=6)
    x = np.random.default_rng(7).uniform(size=(5, 2))
    noise = _t(_jax_noise(jax.random.PRNGKey(7), 6, 5, _d_outs(jparams)))
    monkeypatch.setattr(tdgp, "draw_noise", lambda generator, params, lead, N, like: noise)
    model = tdgp.DeepGaussianProcess(params, tds, num_predict_samples=6)
    for got, want in zip(model.predict(_t(x)), jmodel.predict(jnp.asarray(x))):
        _close(got, want)
    monkeypatch.undo()
    mean, var = model.predict(_t(x))
    mean2, var2 = model.predict(_t(x))
    _close(mean, mean2, rtol=0, atol=0)
    _close(var, var2, rtol=0, atol=0)
    mb, _ = model.predict(_t(x.reshape(5, 1, 2)))
    assert mb.shape == (5, 1, 1)
    mean_y, var_y = model.predict_y(_t(x))
    _close(var_y, var + params.noise_variance)
    assert model.sample(torch.Generator().manual_seed(0), _t(x), 3).shape == (3, 5, 1)
    assert model.get_observation_noise() is params.noise_variance


# -- the deep GP's contracts (tests/unit/test_dgp_contracts.py) ------------------------------


def _prior_layer(kernel, Z, d_out=1):
    M = Z.shape[0]
    return tdgp.DGPLayerParams(kernel=kernel, inducing_points=Z,
                               q_mu=torch.zeros((M, d_out), dtype=F64),
                               q_sqrt=torch.eye(M, dtype=F64).expand(d_out, M, M).clone())


def _contract_data(n=12, seed=0):
    X = _t(np.random.default_rng(seed).uniform(size=(n, 2)))
    return X, torch.sum(torch.square(X - 0.4), dim=-1, keepdim=True)


def _kernel(kind, variance, ls):
    return stationary(kind, variance, ls, dtype=F64, device="cpu")


def test_whitened_prior_recovery_and_prior_elbo():
    X, Y = _contract_data()
    kernel = _kernel("rbf", 1.7, [0.4, 0.7])
    x = _t(np.random.default_rng(3).uniform(size=(9, 2)))
    mean, var = tdgp._layer_moments(_prior_layer(kernel, X[:8]), x)
    _close(mean, torch.zeros(9, 1), atol=1e-9)
    _close(var[:, 0], kernel.diag(x), rtol=1e-6, atol=1e-6)
    X, Y = _contract_data(n=6)
    params = tdgp.DGPParams((_prior_layer(_kernel("rbf", 1.0, [0.5, 0.5]), X),), _t(0.05), _t(0.3))
    gen = torch.Generator().manual_seed(11)
    noise = tdgp.draw_noise(gen, params, (16,), 6, X)
    elbo = tdgp.dgp_elbo_from_noise(params, X, Y, torch.ones(6, dtype=torch.bool), noise)
    f = tdgp.dgp_propagate_from_noise(params, X, noise)
    lik = -0.5 * math.log(2 * math.pi * 0.05) - 0.5 * torch.square(Y[None] - f) / 0.05
    _close(elbo, lik.mean(0).sum(), rtol=1e-6)


def _optimal_whitened_q(kernel, X, Y, noise, mean_constant):
    n = X.shape[0]
    K = gram(kernel, X)
    eye = torch.eye(n, dtype=F64)
    L = torch.linalg.cholesky(K + 1e-6 * eye)
    Kn = K + (noise + 1e-6) * eye
    mu = K @ torch.linalg.solve(Kn, Y - mean_constant)
    Sigma = K - K @ torch.linalg.solve(Kn, K)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    q_cov = Linv @ Sigma @ Linv.T
    return Linv @ mu, torch.linalg.cholesky(q_cov + 1e-6 * eye)[None]


def test_single_layer_optimal_q_collapses_to_exact_gpr():
    X, Y = _contract_data(n=10)
    kernel = _kernel("rbf", 1.3, [0.5, 0.8])
    q_mu, q_sqrt = _optimal_whitened_q(kernel, X, Y, 0.01, 0.2)
    layer = tdgp.DGPLayerParams(kernel, X, q_mu, q_sqrt)
    x = _t(np.random.default_rng(5).uniform(size=(7, 2)))
    mean_l, var_l = tdgp._layer_moments(layer, x)
    gpr = tpost.GPRParams(kernel=kernel, noise_variance=_t(0.01), mean_constant=_t(0.2))
    ds = Dataset.from_arrays(X, Y)
    cache = tpost.build_cache(gpr, ds.query_points, ds.observations, ds.mask)
    mean_g, var_g = tpost.predict_f_reference(gpr, cache, x)
    _close(mean_l + 0.2, mean_g, rtol=1e-3, atol=1e-5)
    _close(var_l, var_g, rtol=1e-2, atol=1e-5)


def test_deterministic_inner_layer_collapses_to_the_outer_layer():
    X, _ = _contract_data(n=8)
    M = X.shape[0]
    inner = tdgp.DGPLayerParams(_kernel("rbf", 0.8, [0.5, 0.5]), X,
                                torch.zeros((M, 2), dtype=F64), torch.zeros((2, M, M), dtype=F64))
    outer = _prior_layer(_kernel("rbf", 1.1, [0.7, 0.7]), X)
    params = tdgp.DGPParams((inner, outer), _t(1e-3), _t(0.5))
    f = tdgp.dgp_propagate_samples(torch.Generator().manual_seed(2), params, X, 40000)
    mean_o, var_o = tdgp._layer_moments(outer, X)
    _close(f.mean(0), 0.5 + mean_o, rtol=0, atol=4e-2)
    _close(f.var(0, correction=0), var_o, rtol=0.15, atol=1e-3)


def test_propagated_sample_moments_match_layer_moments():
    X, Y = _contract_data(n=9)
    kernel = _kernel("matern52", 1.2, [0.6, 0.6])
    q_mu, q_sqrt = _optimal_whitened_q(kernel, X, Y, 0.05, 0.0)
    layer = tdgp.DGPLayerParams(kernel, X, q_mu, q_sqrt)
    params = tdgp.DGPParams((layer,), _t(0.05), _t(0.0))
    x = _t(np.random.default_rng(8).uniform(size=(5, 2)))
    f = tdgp.dgp_propagate_samples(torch.Generator().manual_seed(13), params, x, 6000)
    mean_c, var_c = tdgp._layer_moments(layer, x)
    _close(f.mean(0), mean_c, rtol=0, atol=5e-2)
    _close(f.var(0, correction=0), var_c, rtol=0.2, atol=5e-3)


def test_elbo_improves_under_training_and_stays_under_the_marginal_likelihood():
    X, Y = _contract_data(n=10)
    params = tdgp.DGPParams((_prior_layer(_kernel("rbf", 1.0, [0.5, 0.5]), X),), _t(0.05), _t(0.0))
    mask = torch.ones(10, dtype=torch.bool)
    noise = tdgp.draw_noise(torch.Generator().manual_seed(0), params, (64,), 10, X)
    before = float(tdgp.dgp_elbo_from_noise(params, X, Y, mask, noise))
    result = tdgp.fit_dgp(torch.Generator().manual_seed(0), params, X, Y, mask, num_steps=300,
                          learning_rate=0.02)
    after = float(tdgp.dgp_elbo_from_noise(result.params, X, Y, mask, noise))
    assert after > before
    trained = result.params
    gpr = tpost.GPRParams(kernel=trained.layers[0].kernel, noise_variance=trained.noise_variance,
                          mean_constant=trained.mean_constant)
    assert after <= float(tpost.log_marginal_likelihood(gpr, X, Y, mask)) + 2.0


def test_dgp_wrapper_contracts():
    X, Y = _contract_data(n=14)
    ds = Dataset.from_arrays(X, Y)
    space = tsp.Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")
    model = deepgp.build_vanilla_deep_gp(ds, space, num_layers=2, num_train_steps=50)
    before = [t.clone() for l in model.params.layers for t in (l.q_mu, l.q_sqrt, l.inducing_points)]
    result = model.optimize(ds)
    after = [t for l in model.params.layers for t in (l.q_mu, l.q_sqrt, l.inducing_points)]
    assert any(not torch.allclose(a, b) for a, b in zip(before, after))
    assert torch.isfinite(result.loss) and int(result.num_nonfinite) == 0
    assert all(not t.requires_grad for t in after)


# -- the slice: EGO with PCTS over 4 points through the loop --------------------------------


@pytest.fixture
def jax_pools(monkeypatch):
    """Record the uniforms of the JAX package's box samples; the port's box samples scale
    them."""
    pools = []
    sample = jsp.Box.sample

    def record(self, key, n):
        pools.append(np.asarray(jax.random.uniform(key, (n, self.dimension), dtype=jnp.float64)))
        return sample(self, key, n)

    def replay(self, generator, n):
        u = pools.pop(0)
        assert u.shape == (n, self.dimension)
        return self._scale(_t(u))

    monkeypatch.setattr(jsp.Box, "sample", record)
    monkeypatch.setattr(tsp.Box, "sample", replay)
    return pools


def _branin(x):
    from trieste_tpu_torch.objectives import ScaledBranin

    return ScaledBranin.objective(x)


def _loop_in_both(jmodel, tmodel, jopt_, topt_, X, num_steps=2):
    """``num_steps`` EGO steps of PCTS over 4 points on ScaledBranin in both packages; the
    port's observer observes the JAX points (held to atol 1e-6)."""
    from trieste_tpu.objectives import single_objectives as jobj

    jspace = jsp.Box([0.0, 0.0], [1.0, 1.0])
    tspace = tsp.Box([0.0, 0.0], [1.0, 1.0], dtype=F64, device="cpu")
    jds = JDataset.from_arrays(jnp.asarray(X), jobj.scaled_branin(jnp.asarray(X)))
    tds = Dataset.from_arrays(_t(X), _t(jds.trimmed_observations))
    asked = []

    def jobs(qp):
        y = jobj.scaled_branin(qp)
        asked.append((np.asarray(qp), np.asarray(y)))
        return JDataset.from_arrays(qp, y)

    def tobs(qp):
        x, y = asked.pop(0)
        np.testing.assert_allclose(qp.numpy(), x, atol=1e-6)
        return Dataset.from_arrays(_t(x), _t(y))

    jresult = jt.BayesianOptimizer(jobs, jspace).optimize(
        num_steps, jds, jmodel(jds, jspace),
        jrule.EfficientGlobalOptimization(jcts.ParallelContinuousThompsonSampling(),
                                          optimizer=jopt_, num_query_points=4),
        key=jax.random.PRNGKey(5), track_state=False,
    )
    tresult = BayesianOptimizer(tobs, tspace).optimize(
        num_steps, tds, tmodel(tds, tspace),
        trule.EfficientGlobalOptimization(ParallelContinuousThompsonSampling(), optimizer=topt_,
                                          num_query_points=4),
        track_state=False,
    )
    assert jresult.is_ok and tresult.is_ok, tresult.final_result
    assert not asked
    jfinal, tfinal = jresult.try_get_final_dataset(), tresult.try_get_final_dataset()
    assert len(tfinal) == len(jfinal) == len(X) + 4 * num_steps
    _close(tfinal.trimmed_query_points, jfinal.trimmed_query_points, rtol=0, atol=1e-6)
    return jresult, tresult


def test_two_pcts_steps_of_the_deep_ensemble_match_jax(jax_pools, monkeypatch):
    """The JAX fits' bootstraps and trajectories' members are recorded as the JAX run makes
    them and replayed in the port's; the continuous optimizer's seed pools likewise."""
    boots, members = [], []
    jfit = jde.fit_deep_ensemble

    def record_fit(key, network, params, X, Y, mask, **kwargs):
        boots.append(np.array(_jax_bootstrap(key, kwargs["ensemble_size"], X.shape[0], mask)))
        return jfit(key, network, params, X, Y, mask, **kwargs)

    jget = jde.DeepEnsembleTrajectorySampler.get_trajectory

    def record_trajectory(self, key, batch_size=1):
        traj = jget(self, key, batch_size)
        members.append((np.array(traj.indices), np.array(traj.eps)))
        return traj

    def replay_trajectory(self, generator, batch_size=1):
        indices, eps = members.pop(0)
        return tde._EnsembleTrajectory(self._model.params, torch.as_tensor(indices), _t(eps))

    monkeypatch.setattr(jde, "fit_deep_ensemble", record_fit)
    monkeypatch.setattr(jde.DeepEnsembleTrajectorySampler, "get_trajectory", record_trajectory)
    monkeypatch.setattr(tde, "bootstrap_indices", lambda g, mask, E: torch.as_tensor(boots.pop(0)))
    monkeypatch.setattr(tde.DeepEnsembleTrajectorySampler, "get_trajectory", replay_trajectory)

    def jmodel(ds, space):
        return _in_float64(jde.build_deep_ensemble(ds, ensemble_size=3, hidden_units=(10, 10),
                                                   num_train_steps=20, key=jax.random.PRNGKey(2)))

    def tmodel(ds, space):
        init = jde.build_deep_ensemble(JDataset.from_arrays(jnp.asarray(_np(ds.trimmed_query_points)),
                                                            jnp.asarray(_np(ds.trimmed_observations))),
                                       ensemble_size=3, hidden_units=(10, 10), key=jax.random.PRNGKey(2))
        return tde.DeepEnsemble(_ensemble_from_jax(_in_float64(init).params), ds, num_train_steps=20)

    X = np.random.default_rng(10).uniform(size=(6, 2))
    _loop_in_both(jmodel, tmodel, jopt.generate_continuous_optimizer(200, 2),
                  topt.generate_continuous_optimizer(200, 2), X)
    assert not boots and not members and not jax_pools


def test_two_pcts_steps_of_the_deep_gp_match_jax(jax_pools, monkeypatch):
    """The JAX fits' noise and the trajectories' keys are recorded as the JAX run makes
    them; each port fit takes the noise of its JAX twin, and each port trajectory the
    normals the JAX one draws at the call's number of rows. Random search maximizes: the
    JAX L-BFGS evaluates each run in its own vmapped call, where a trajectory's noise has
    one row, and the port's lockstep L-BFGS evaluates all runs in one call, where it has
    one per run, so the two optimize different draws of the same path."""
    fits, keys = [], []
    jfit = jdgp.fit_dgp

    def record_fit(key, params, X, Y, mask, num_steps=2000, learning_rate=0.01, num_samples=8):
        fits.append(np.asarray(_jax_fit_noise(key, num_steps, num_samples, X.shape[0], _d_outs(params))))
        return jfit(key, params, X, Y, mask, num_steps=num_steps, learning_rate=learning_rate,
                    num_samples=num_samples)

    def replay_fit(generator, params, X, Y, mask, num_steps=2000, learning_rate=0.01, num_samples=8):
        noise = _t(fits.pop(0))
        assert noise.shape[:3] == (num_steps, num_samples, X.shape[0])
        return tdgp.fit_dgp_from_noise(noise, params, X, Y, mask, learning_rate)

    jget = jdgp._DGPTrajectorySampler.get_trajectory

    def record_trajectory(self, key, batch_size=1):
        traj = jget(self, key, batch_size)
        keys.append(np.asarray(traj.keys))
        return traj

    class Replay(tdgp._DGPTrajectory):
        def __call__(self, x):
            d_outs = tuple(l.q_mu.shape[-1] for l in self.params.layers)
            noise = np.stack([np.asarray(_jax_noise(jnp.asarray(k), 1, x.shape[0], d_outs))[0]
                              for k in self.seed])
            return tdgp.dgp_trajectory_from_noise(self.params, x, _t(noise))

    monkeypatch.setattr(jdgp, "fit_dgp", record_fit)
    monkeypatch.setattr(jdgp._DGPTrajectorySampler, "get_trajectory", record_trajectory)
    monkeypatch.setattr(tdgp, "fit_dgp", replay_fit)
    monkeypatch.setattr(tdgp._DGPTrajectorySampler, "get_trajectory",
                        lambda self, generator, batch_size=1: Replay(self._model.params, keys.pop(0)))

    def jmodel(ds, space):
        return jdgp.build_vanilla_deep_gp(ds, space, num_layers=2, num_inducing_points=8,
                                          num_train_steps=15, key=jax.random.PRNGKey(3))

    def tmodel(ds, space):
        jinit = jdgp.build_vanilla_deep_gp(
            JDataset.from_arrays(jnp.asarray(_np(ds.trimmed_query_points)),
                                 jnp.asarray(_np(ds.trimmed_observations))),
            jsp.Box([0.0, 0.0], [1.0, 1.0]), num_layers=2, num_inducing_points=8,
            key=jax.random.PRNGKey(3))
        return tdgp.DeepGaussianProcess(_dgp_from_jax(jinit.params), ds, num_train_steps=15)

    X = np.random.default_rng(11).uniform(size=(6, 2))
    _loop_in_both(jmodel, tmodel, jopt.generate_random_search_optimizer(300),
                  topt.generate_random_search_optimizer(300), X)
    assert not fits and not keys and not jax_pools
