"""The port's entropy search (MES, GIBBON) and greedy batches (local penalization, the
Fantasizer and its conditioned model), the memory-lean conditioned marginal, and the
slice as a whole, on the CPU against the JAX package in float64.

The JAX builders draw from their keys (the grid and the Gumbel uniforms of MES, the
Lipschitz points of local penalization, the fantasized samples); the tests rebuild those
draws with the JAX code's splits and feed them to the port (``Box.sample``, ``uniform`` of
the sampler module, ``standard_normal`` of the posterior module). Given the same draws
everything agrees at rtol 1e-9 / atol 1e-10; the slice (two Ask/Tell rounds of local
penalization and of the Fantasizer, three points each, seed pools and fit restarts
injected too) at atol 1e-6 on the points. The closed-form checks of the JAX package's own
tests follow, on the port.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch
from jax.tree_util import Partial

from trieste_tpu import ask_tell_optimization as jat
from trieste_tpu.acquisition import rule as jrule
from trieste_tpu.acquisition.function import entropy as jent
from trieste_tpu.acquisition.function import functional as jfl
from trieste_tpu.acquisition.function import greedy_batch as jgb
from trieste_tpu.acquisition.optimizer import generate_random_search_optimizer as jrandom
from trieste_tpu.acquisition.utils import joint_predictor as jjoint
from trieste_tpu.acquisition.utils import predictor as jpredictor
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models.gp import builders as jbuilders
from trieste_tpu.models.gp import posterior as jpost
from trieste_tpu.models.gp import training as jtrain
from trieste_tpu.models.gp.gpr import GaussianProcessRegression as JGPR
from trieste_tpu.ops.kernels import stationary as jstationary
from trieste_tpu.space import Box as JBox
from trieste_tpu_torch import AskTellOptimizer, Box, Dataset, convert
from trieste_tpu_torch.acquisition import optimizer as topt
from trieste_tpu_torch.acquisition import rule as trule
from trieste_tpu_torch.acquisition import sampler as tts
from trieste_tpu_torch.acquisition.function import entropy as tent
from trieste_tpu_torch.acquisition.function import function as tfun
from trieste_tpu_torch.acquisition.function import functional as tfl
from trieste_tpu_torch.acquisition.function import greedy_batch as tgb
from trieste_tpu_torch.models.gp import build_gpr
from trieste_tpu_torch.models.gp import gpr as tgpr
from trieste_tpu_torch.models.gp import posterior as tpost
from trieste_tpu_torch.models.gp import training as ttrain
from trieste_tpu_torch.models.gp.gpr import GaussianProcessRegression

torch.set_num_threads(1)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-10)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _pair(scale=1.0, noise=1e-2):
    """The same 2-D GPR (capacity 16, partly padded) in both packages, float64, and the
    box [-1, 1]² in both."""
    X = np.random.default_rng(0).uniform(-1.0, 1.0, size=(9, 2))
    Y = scale * (np.sin(3.0 * X[:, :1]) + X[:, 1:] ** 2)
    jm = JGPR(jpost.GPRParams(jstationary("matern52", 1.1, [0.6, 0.8], dtype=jnp.float64),
                              jnp.asarray(noise), jnp.asarray(0.2)),
              JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y)))
    tm = GaussianProcessRegression(
        convert.gpr_params_from_numpy("matern52", 1.1, [0.6, 0.8], noise, 0.2, device="cpu",
                                      dtype=F64),
        Dataset.from_arrays(_t(X), _t(Y)),
    )
    return jm, tm


@pytest.fixture(scope="module", autouse=True)
def compiled_jax_conditioning():
    """The JAX package's conditioned predictions compiled whole: run op by op, as its
    fantasized model calls them outside ``jit``, they compile hundreds of primitives
    (25 s for one greedy batch here). The numbers are the same."""
    patch = pytest.MonkeyPatch()
    for name in ("conditional_predict_f", "conditional_predict_joint", "conditional_predict_y"):
        patch.setattr(jpost, name, jax.jit(getattr(jpost, name)))
    yield
    patch.undo()


@pytest.fixture(scope="module")
def pair():
    jm, tm = _pair()
    return jm, tm, jm.get_internal_data(), tm.dataset


JSPACE = JBox([-1.0, -1.0], [1.0, 1.0])
TSPACE = Box([-1.0, -1.0], [1.0, 1.0], dtype=F64, device="cpu")
PENDING = np.array([[0.5, -0.5], [-0.2, 0.6]])


def _x(lead=(12,), seed=1):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=lead + (1, 2))


_APPLY = jax.jit(lambda f, x: f(x))
"""A JAX acquisition function at ``x``, compiled whole (op by op it compiles every
primitive anew, several seconds a function); a ``Partial`` is an argument, so a function
of the same structure and shapes compiles once."""


def _same(tfn, jfn, x, tol=TOL):
    got, want = tfn(_t(x)), np.asarray(_APPLY(jfn, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)


# -- entropy ------------------------------------------------------------------------------------


def test_entropy_functions_match_jax(pair):
    jm, tm, _, _ = pair
    mins = np.array([[-0.9], [-0.6], [-0.75]])
    noise = 0.05
    _same(lambda x: tent._mes_fn(tm.predict, _t(mins), x),
          Partial(jent._mes_fn, jpredictor(jm), jnp.asarray(mins)), _x())
    _same(lambda x: tent._gibbon_quality_fn(tm.predict, noise, _t(mins), x),
          Partial(jent._gibbon_quality_fn, jpredictor(jm), jnp.asarray(noise), jnp.asarray(mins)),
          _x())
    _same(lambda x: tent._gibbon_repulsion_fn(tm.predict_joint, noise, _t(PENDING), x),
          Partial(jent._gibbon_repulsion_fn, jpredictor(jm), jjoint(jm), jnp.asarray(noise),
                  jnp.asarray(PENDING)), _x((3, 4)))
    _same(tfl.min_value_entropy_search(tm, _t(mins)), jfl.min_value_entropy_search(jm, mins), _x())
    _same(tfl.gibbon_quality_term(tm, _t(mins)), jfl.gibbon_quality_term(jm, mins), _x())
    _same(tfl.gibbon_repulsion_term(tm, _t(PENDING)), jfl.gibbon_repulsion_term(jm, PENDING), _x())


def _mes_draws(key, grid_size, num_samples):
    """The grid and the Gumbel uniforms that a JAX MES builder keyed ``key`` draws at its
    next preparation (entropy.py: the key splits in three; sampler.py: the uniforms)."""
    _, k_grid, k_sample = jax.random.split(key, 3)
    grid = JSPACE.sample(k_grid, grid_size)
    u = jax.random.uniform(k_sample, (num_samples, 1), dtype=jnp.float64, minval=1e-12,
                           maxval=1.0 - 1e-12)
    return _t(grid), _t(u)


def test_mes_matches_jax_given_its_draws(pair, monkeypatch):
    jm, tm, jds, tds = pair
    key = jax.random.PRNGKey(5)
    jfn = jent.MinValueEntropySearch(JSPACE, 4, 50, key=key).prepare_acquisition_function(jm, jds)
    grid, u = _mes_draws(key, 50, 4)
    monkeypatch.setattr(Box, "sample", lambda self, generator, n: grid)
    monkeypatch.setattr(tts, "uniform", lambda generator, shape, like: u)
    builder = tent.MinValueEntropySearch(TSPACE, 4, 50)
    _same(builder.prepare_acquisition_function(tm, tds), jfn, _x())
    assert builder._generator.initial_seed() == 0  # made at the first draw, on the data's device


def test_gibbon_matches_jax_given_its_draws_and_keeps_them_through_a_batch(pair, monkeypatch):
    jm, tm, jds, tds = pair
    key = jax.random.PRNGKey(6)
    jbuilder = jent.GIBBON(JSPACE, 4, 50, key=key)
    jfirst = jbuilder.prepare_acquisition_function(jm, jds)
    jsecond = jbuilder.update_acquisition_function(jfirst, jm, jds, jnp.asarray(PENDING),
                                                   new_optimization_step=False)
    grid, u = _mes_draws(key, 50, 4)
    monkeypatch.setattr(Box, "sample", lambda self, generator, n: grid)
    monkeypatch.setattr(tts, "uniform", lambda generator, shape, like: u)
    builder = tent.GIBBON(TSPACE, 4, 50)
    first = builder.prepare_acquisition_function(tm, tds)
    _same(first, jfirst, _x())
    samples = builder._min_value_samples
    second = builder.update_acquisition_function(first, tm, tds, _t(PENDING),
                                                 new_optimization_step=False)
    assert builder._min_value_samples is samples
    _same(second, jsecond, _x())
    with pytest.raises(ValueError, match="non-empty dataset"):
        builder.prepare_acquisition_function(tm, None)


# -- local penalization ------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["_soft_penalizer_fn", "_hard_penalizer_fn"])
def test_penalizers_match_jax(pair, name):
    jm, tm, _, _ = pair
    lipschitz, eta = 12.0, -0.4
    _same(lambda x: getattr(tgb, name)(tm.predict, lipschitz, eta, _t(PENDING), x),
          Partial(getattr(jgb, name), jpredictor(jm), jnp.asarray(lipschitz), jnp.asarray(eta),
                  jnp.asarray(PENDING)), _x((3, 4)))
    form = "soft_local_penalizer" if name.startswith("_soft") else "hard_local_penalizer"
    _same(getattr(tfl, form)(tm, _t(PENDING), lipschitz, eta),
          getattr(jfl, form)(jm, PENDING, jnp.asarray(lipschitz), jnp.asarray(eta)), _x())


@pytest.fixture(scope="module")
def steep_pair():
    """A model whose mean is steep enough that the Lipschitz estimate is above its floor."""
    jm, tm = _pair(scale=40.0)
    return jm, tm, jm.get_internal_data(), tm.dataset


@pytest.mark.parametrize("penalizer", ["soft", "hard"])
def test_local_penalization_matches_jax_given_its_draws(steep_pair, monkeypatch, penalizer):
    """The Lipschitz points the JAX builder draws (its key splits in two) fed to the
    port; then a batch: no pending point, one, two, the base function kept through it."""
    jm, tm, jds, tds = steep_pair
    key = jax.random.PRNGKey(7)
    jbuilder = jgb.LocalPenalization(JSPACE, 60, penalizer, key=key)
    samples = _t(JSPACE.sample(jax.random.split(key)[1], 60))
    monkeypatch.setattr(Box, "sample", lambda self, generator, n: samples)
    builder = tgb.LocalPenalization(TSPACE, 60, penalizer)
    jfn = jbuilder.prepare_acquisition_function(jm, jds)
    fn = builder.prepare_acquisition_function(tm, tds)
    assert 10.0 < float(builder._lipschitz)  # above the floor: the gradients are compared
    np.testing.assert_allclose(float(builder._lipschitz), float(jbuilder._lipschitz), **TOL)
    _same(fn, jfn, _x())
    base = builder._base_fn
    for k in (1, 2):
        jfn = jbuilder.update_acquisition_function(jfn, jm, jds, jnp.asarray(PENDING[:k]),
                                                   new_optimization_step=False)
        fn = builder.update_acquisition_function(fn, tm, tds, _t(PENDING[:k]),
                                                 new_optimization_step=False)
        _same(fn, jfn, _x())
    assert builder._base_fn is base


def test_lipschitz_floor_and_arguments(pair):
    _, tm, _, tds = pair
    flat = tgb._lipschitz_from_samples(tm, torch.zeros(5, 2, dtype=F64) + 0.3)
    assert float(flat) >= 10.0
    with pytest.raises(ValueError, match="penalizer must be"):
        tgb.LocalPenalization(TSPACE, penalizer="medium")
    with pytest.raises(ValueError, match="num_samples must be positive"):
        tgb.LocalPenalization(TSPACE, num_samples=0)
    with pytest.raises(ValueError, match="non-empty dataset"):
        tgb.LocalPenalization(TSPACE).prepare_acquisition_function(tm, None)


# -- the fantasized model and the Fantasizer -------------------------------------------------------


@pytest.fixture(scope="module")
def model_1d():
    """Five points of a 1-D sine in both packages, and the rest of the line for fantasies."""
    x = np.arange(1.0, 24.0)[:, None] / 8.0
    y = np.sin(2.0 * x / 3.0)
    jm = JGPR(jpost.GPRParams(jstationary("rbf", 1.0, [0.6], dtype=jnp.float64),
                              jnp.asarray(1e-4), jnp.asarray(0.0)),
              JDataset.from_arrays(jnp.asarray(x[:5]), jnp.asarray(y[:5])))
    tm = GaussianProcessRegression(
        convert.gpr_params_from_numpy("rbf", 1.0, [0.6], 1e-4, 0.0, device="cpu", dtype=F64),
        Dataset.from_arrays(_t(x[:5]), _t(y[:5])),
    )
    return jm, tm, x, y


def test_fantasized_model_with_batch_ranks_matches_jax(model_1d):
    """Fantasy ``[3, 6, 1]`` and queries ``[4, 5, 1]`` give ``[4, 3, 5, 1]``, query dims
    first, in both packages."""
    jm, tm, x, y = model_1d
    fx, fy = x[5:].reshape(3, 6, 1), y[5:].reshape(3, 6, 1)
    qp = (np.arange(1.0, 21.0)[:, None] / 20.0).reshape(4, 5, 1)
    jf = jgb._FantasizedModel(jm, fantasy_X=jnp.asarray(fx), fantasy_Y=jnp.asarray(fy))
    tf = tgb._FantasizedModel(tm, fantasy_X=_t(fx), fantasy_Y=_t(fy))
    for method in ("predict", "predict_joint", "predict_y"):
        got, want = getattr(tf, method)(_t(qp)), getattr(jf, method)(jnp.asarray(qp))
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w, **TOL)
    assert tf.sample(torch.Generator().manual_seed(0), _t(qp), 7).shape == (4, 3, 7, 5, 1)
    flat = tgb._FantasizedModel(tm, Dataset.from_arrays(_t(x[5:11]), _t(y[5:11]), capacity=6))
    np.testing.assert_allclose(
        flat.predict(_t(qp[0]))[1].numpy(),
        tgb._FantasizedModel(tm, fantasy_X=_t(x[5:11]), fantasy_Y=_t(y[5:11])).predict(
            _t(qp[0]))[1].numpy(), **TOL)
    with pytest.raises(ValueError, match="fantasy"):
        tgb._FantasizedModel(tm)


def test_batch_fantasies_match_a_refit_and_compose_with_vectorized_queries(model_1d):
    """Fantasy batch b's posterior is that of a GPR holding the data and fantasy b; query
    slice v of ``[N, V, 1, D]`` meets fantasy batch v on the diagonal."""
    _, tm, x, y = model_1d
    fx, fy = _t(x[5:17].reshape(2, 6, 1)), _t(y[5:17].reshape(2, 6, 1))
    q = torch.linspace(0.1, 2.5, 9, dtype=F64)[:, None]
    mean_b, var_b = tgb._FantasizedModel(tm, fantasy_X=fx, fantasy_Y=fy).predict(q)  # [2, 9, 1]
    for b in range(2):
        refit = GaussianProcessRegression(tm.params, Dataset.from_arrays(
            torch.cat([tm.dataset.trimmed_query_points, fx[b]]),
            torch.cat([tm.dataset.trimmed_observations, fy[b]])))
        mean_r, var_r = refit.predict(q)
        np.testing.assert_allclose(mean_b[b].numpy(), mean_r.numpy(), atol=1e-5)
        np.testing.assert_allclose(var_b[b].numpy(), var_r.numpy(), atol=1e-5)
    xs = torch.linspace(0.0, 3.0, 8, dtype=F64)[:, None]
    mean, _ = tgb._FantasizedModel(tm, fantasy_X=fx, fantasy_Y=fy).predict(
        xs[:, None, None, :].expand(8, 2, 1, 1))  # [8, 2, 2, 1, 1]
    for v in range(2):
        flat, _ = tgb._FantasizedModel(tm, fantasy_X=fx[v], fantasy_Y=fy[v]).predict(xs)
        np.testing.assert_allclose(mean[:, v, v, 0].numpy(), flat.numpy(), **TOL)


@pytest.mark.parametrize("method", ["KB", "sample"])
def test_fantasizer_matches_jax(pair, monkeypatch, method):
    """Kriging believer, and one posterior sample from the draws the JAX builder makes
    (its key splits in two; posterior.py draws ``[P, S, B]``)."""
    jm, tm, jds, tds = pair
    key = jax.random.PRNGKey(8)
    jfn = jgb.Fantasizer(fantasize_method=method, key=key).prepare_acquisition_function(
        jm, jds, jnp.asarray(PENDING))
    eps = _t(jax.random.normal(jax.random.split(key)[1], (1, 1, 2), dtype=jnp.float64))
    monkeypatch.setattr(tpost, "standard_normal", lambda generator, shape, like: eps)
    builder = tgb.Fantasizer(fantasize_method=method)
    _same(builder.prepare_acquisition_function(tm, tds, _t(PENDING)), jfn, _x())
    _same(builder.update_acquisition_function(None, tm, tds, None),
          jgb.Fantasizer().prepare_acquisition_function(jm, jds), _x())
    with pytest.raises(ValueError, match="fantasize_method"):
        tgb.Fantasizer(fantasize_method="guess")


# -- the conditioned marginal without the [B, B] block ----------------------------------------


def test_conditional_predict_f_at_fifty_thousand_queries():
    """B = 50,000 queries in float64: a ``[B, B]`` block would take 20 GB. The first 2048
    rows agree with the diagonal of the joint form; the rest are finite and positive."""
    rng = np.random.default_rng(9)
    X = rng.uniform(size=(20, 3))
    model = GaussianProcessRegression(
        convert.gpr_params_from_numpy("matern52", 0.8, [0.4, 0.5, 0.6], 1e-3, 0.1, device="cpu",
                                      dtype=F64),
        Dataset.from_arrays(_t(X), _t(np.cos(X.sum(-1, keepdims=True)))),
    )
    assert model.dataset.capacity == 32
    q = _t(rng.uniform(size=(50_000, 3)))
    ex, ey = _t(rng.uniform(size=(2, 3))), _t(rng.normal(size=(2, 1)))
    mean, var = tpost.conditional_predict_f(model.params, model.posterior_cache, q, ex, ey)
    assert mean.shape == var.shape == (50_000, 1)
    jmean, jcov = tpost.conditional_predict_joint(model.params, model.posterior_cache, q[:2048],
                                                  ex, ey)
    np.testing.assert_allclose(mean[:2048].numpy(), jmean.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(var[:2048, 0].numpy(), torch.diagonal(jcov[0]).numpy(), rtol=1e-9,
                               atol=1e-12)
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())


# -- closed forms on the port ------------------------------------------------------------------------


def test_penalizers_match_their_formulas(pair):
    _, tm, _, _ = pair
    lipschitz, eta = 12.0, 0.05
    pending = torch.tensor([[0.4, 0.1], [-0.3, 0.2]], dtype=F64)
    x = torch.tensor([[[0.1, -0.2]]], dtype=F64)
    mean, var = (t[:, 0].numpy() for t in tm.predict(pending))
    r = np.linalg.norm(x[0, 0].numpy() - pending.numpy(), axis=-1)
    z = (r - (mean - eta) / lipschitz) / (np.sqrt(2.0) * np.sqrt(var) / lipschitz)
    soft = tgb._soft_penalizer_fn(tm.predict, lipschitz, eta, pending, x)
    np.testing.assert_allclose(float(soft), np.prod(0.5 * scipy.special.erfc(-z)), rtol=1e-10)
    hard = tgb._hard_penalizer_fn(tm.predict, lipschitz, eta, pending, x)
    want = np.prod(np.minimum(1.0, lipschitz * r / (mean - eta + np.sqrt(var))))
    np.testing.assert_allclose(float(hard), want, rtol=1e-10)


@pytest.mark.parametrize("kind", ["soft", "hard"])
def test_penalizers_lie_in_the_unit_interval(pair, kind):
    _, tm, _, _ = pair
    pending = torch.tensor([[0.0, 0.0]], dtype=F64)
    eta = tm.predict(pending)[0][0, 0]  # the pending point's own mean: r = 0 gives 0.5 or 0
    fn = tgb._soft_penalizer_fn if kind == "soft" else tgb._hard_penalizer_fn
    penalizer = lambda x: fn(tm.predict, 10.0, eta, pending, x)  # noqa: E731
    grid = torch.linspace(-1.0, 1.0, 9, dtype=F64)[:, None, None].expand(9, 1, 2)
    vals = penalizer(grid)
    assert bool((vals >= 0.0).all()) and bool((vals <= 1.0 + 1e-9).all())
    assert float(penalizer(pending[None])) <= 0.5 + 1e-12


def test_penalized_function_is_base_times_penalizer(steep_pair):
    _, tm, _, tds = steep_pair
    builder = tgb.LocalPenalization(TSPACE, penalizer="hard",
                                    generator=torch.Generator().manual_seed(3))
    fn = builder.prepare_acquisition_function(tm, tds, _t(PENDING[:1]))
    penalizer = tfl.hard_local_penalizer(tm, _t(PENDING[:1]), builder._lipschitz, builder._eta)
    x = _t(_x())
    np.testing.assert_allclose(fn(x).numpy(), (builder._base_fn(x) * penalizer(x)).numpy(), **TOL)
    near = _t(PENDING[:1])[None] + 0.01
    assert float(fn(near)) < float(builder._base_fn(near))


def test_mes_and_gibbon_rank_like_probability_of_improvement(pair):
    """With one sampled minimum, MES is a monotone function of the probability of
    improving on it, and GIBBON's quality term shares MES's argmax."""
    _, tm, _, _ = pair
    g = torch.linspace(-1.0, 1.0, 21, dtype=F64)
    grid = torch.stack(torch.meshgrid(g, g, indexing="xy"), -1).reshape(-1, 1, 2)
    mins = torch.tensor([[-0.5]], dtype=F64)
    mes = tent._mes_fn(tm.predict, mins, grid)[:, 0].numpy()
    poi = tfun._poi_fn(tm.predict, torch.tensor(-0.5, dtype=F64), grid)[:, 0].numpy()
    assert int(np.argmax(mes)) == int(np.argmax(poi))
    assert np.diff(mes[np.argsort(poi)]).min() > -1e-9
    quality = tent._gibbon_quality_fn(tm.predict, tm.get_observation_noise(), mins, grid)
    assert int(torch.argmax(quality)) == int(np.argmax(mes))


def test_gibbon_repulsion_is_nonpositive_and_fades_with_distance(pair):
    _, tm, _, _ = pair
    pending = torch.tensor([[0.0, 0.0]], dtype=F64)
    rep = lambda x: float(tent._gibbon_repulsion_fn(  # noqa: E731
        tm.predict_joint, tm.get_observation_noise(), pending, torch.tensor(x, dtype=F64)))
    near, far = rep([[[0.05, 0.0]]]), rep([[[3.0, 3.0]]])
    assert near < far <= 1e-9 and abs(far) < 1e-2


# -- the slice as a whole ------------------------------------------------------------------------------


@pytest.fixture
def jax_restarts(monkeypatch):
    """Make the port's fit start from the restarts that the JAX model is about to draw."""
    queue = []

    def next_fit(jmodel):
        sub = jax.random.split(jmodel._key)[1]
        queue.append(np.asarray(jtrain.randomize_starts(
            sub, jmodel.params, jmodel._num_kernel_samples, jmodel._train_noise,
            priors=jmodel._priors,
        )))

    def fit_from_queue(generator, params, X, Y, mask, *, num_starts, train_noise, max_iters, priors,
                pool_sharding):
        return ttrain.fit_gpr_from_starts(_t(queue.pop(0)), params, X, Y, mask,
                                          train_noise=train_noise, max_iters=max_iters, priors=priors,
                                          pool_sharding=pool_sharding)

    monkeypatch.setattr(tgpr, "fit_gpr", fit_from_queue)
    return next_fit


@pytest.fixture(scope="module")
def slice_data():
    """Nine points (capacity 16 throughout the two rounds), and the JAX fit at that
    capacity compiled once for the module."""
    X = np.random.default_rng(10).uniform(-1.0, 1.0, size=(9, 2))
    Y = np.sum(X**2, -1, keepdims=True) + 0.3 * X[:, :1]
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y))
    jbuilders.build_gpr(jds, JSPACE, num_kernel_samples=3).optimize(jds)
    return X, Y


@pytest.mark.parametrize("rule", ["lp", "fantasizer"])
def test_greedy_batches_match_jax_over_two_rounds(monkeypatch, jax_restarts, slice_data, rule):
    """Two Ask/Tell rounds of three points each: the JAX candidate pools (one key per
    point, split from the ask's key), the Lipschitz points and the fit restarts go into the
    port. Each point is the best of its pool (random search; the optimizers' own parity is
    held in ``test_torch_ask_tell.py``), the pool's scores compiled whole on the JAX side."""
    X, Y = slice_data
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y))
    jmodel = jbuilders.build_gpr(jds, JSPACE, num_kernel_samples=3,
                                 optimize_key=jax.random.PRNGKey(11))
    tds = Dataset.from_arrays(_t(X), _t(Y))
    tmodel = build_gpr(tds, TSPACE, num_kernel_samples=3)
    N, B, n_lip = 256, 3, 60  # 60 Lipschitz points, as above: the JAX gradients compile once
    jbuilder = (jgb.LocalPenalization(JSPACE, n_lip, key=jax.random.PRNGKey(12)) if rule == "lp"
                else jgb.Fantasizer())
    tbuilder = tgb.LocalPenalization(TSPACE, n_lip) if rule == "lp" else tgb.Fantasizer()
    jax_restarts(jmodel)

    def jax_random_search(space, f, key):  # jrandom(N) with the scores compiled whole
        seeds = space.sample(key, N)[:, None, :]
        return seeds[jnp.argmax(_APPLY(f, seeds)[:, 0])]

    bowl = Partial(lambda x: -jnp.sum(x**2, -1))
    assert np.array_equal(jax_random_search(JSPACE, bowl, jax.random.PRNGKey(0)),
                          jrandom(N)(JSPACE, bowl, jax.random.PRNGKey(0)))
    jopt = jat.AskTellOptimizer(JSPACE, jds, jmodel, jrule.EfficientGlobalOptimization(
        jbuilder, jax_random_search, num_query_points=B), key=jax.random.PRNGKey(13))
    draws = []
    monkeypatch.setattr(Box, "sample", lambda self, generator, n: draws.pop(0))
    topt_ = AskTellOptimizer(TSPACE, tds, tmodel, trule.EfficientGlobalOptimization(
        tbuilder, topt.generate_random_search_optimizer(N), num_query_points=B))
    for _ in range(2):
        if rule == "lp":
            draws.append(_t(JSPACE.sample(jax.random.split(jbuilder._key)[1], n_lip)))
        keys = jax.random.split(jax.random.split(jopt._key)[1], B)
        draws.extend(_t(JSPACE.sample(k, N)) for k in keys)
        want = np.asarray(jopt.ask())
        got = topt_.ask()
        assert got.shape == (B, 2) and not draws
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        assert np.min(np.linalg.norm(want[:, None] - want[None], axis=-1) + 9 * np.eye(B)) > 1e-3
        Y = np.sum(want**2, -1, keepdims=True) + 0.3 * want[:, :1]
        jax_restarts(jmodel)
        jopt.tell(JDataset.from_arrays(jnp.asarray(want), jnp.asarray(Y)))
        topt_.tell(Dataset.from_arrays(_t(want), _t(Y)))
    assert len(topt_.dataset) == 15 and topt_.dataset.capacity == 16
