"""The port's search-space constraints on the CPU, against the JAX package in float64.

Residuals, feasibility, shifts, products and equality at rtol 1e-12; the three feasible
samplers on the JAX package's draws (each try's uniforms or Halton points recorded as the
JAX package makes them and replayed into the port), compared exactly, and their timeout;
the constraint-aware optimizer's core from the JAX seed pool on the JAX package's unit
cases (points and values at rtol 1e-9), with the penalty's gradient; the fast feasibility
function's values and gradients; the feasible incumbent of EI and ECI; the reference's
``ConstrainedScaledBranin`` gap; ``chip_smoke.GARDNER_DESIGN``; and the slice: three steps
of EGO with EI on ``ConstrainedScaledBranin`` through ``BayesianOptimizer.optimize`` in
both packages, the JAX run's seed pools and fit restarts replayed into the port's, query
points at atol 1e-6. A ``NonlinearConstraint``'s function cannot cross packages: each test
writes its torch twin by hand.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import Partial

import trieste_tpu as jt
from trieste_tpu import space as jsp
from trieste_tpu.acquisition import optimizer as jopt
from trieste_tpu.acquisition import rule as jrule
from trieste_tpu.acquisition.function import function as jfun
from trieste_tpu.data import Dataset as JDataset
from trieste_tpu.models.gp import builders as jbuilders
from trieste_tpu.models.gp.gpr import GaussianProcessRegression as JGPR
from trieste_tpu.models.gp.training import randomize_starts as _RANDOMIZE_STARTS
from trieste_tpu.objectives import ConstrainedScaledBranin as JConstrainedScaledBranin
from trieste_tpu.objectives import utils as jobj
from trieste_tpu_torch import BayesianOptimizer, Dataset, convert
from trieste_tpu_torch import space as tsp
from trieste_tpu_torch.acquisition import optimizer as topt
from trieste_tpu_torch.acquisition import rule as trule
from trieste_tpu_torch.acquisition.function import function as tfun
from trieste_tpu_torch.models.gp import build_gpr, gpr as tgpr, training as ttrain
from trieste_tpu_torch.objectives import ConstrainedScaledBranin, mk_observer
from trieste_tpu_torch.observer import OBJECTIVE

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def quick_jax_compiles():
    """XLA's optimizations off while this module runs: compiling dominates the JAX side's
    time, and the results agree to the same tolerances."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


F64 = torch.float64
RTOL = 1e-12  # residuals, products, shifts: the same arithmetic in both packages


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=F64)


def _jit(f, *args):
    """``f(*args)`` compiled whole: JAX run op by op compiles every primitive anew."""
    return np.asarray(jax.jit(f)(*args))


def _jdisk(x):
    z = x - 0.5
    return jnp.sqrt(z[..., 0] ** 2 + z[..., 1] ** 2) - 0.4


def _tdisk(x):
    z = x - 0.5
    return torch.sqrt(z[..., 0] ** 2 + z[..., 1] ** 2) - 0.4


A, LB, UB = [[1.0, -1.0], [0.5, 2.0]], [-0.2, 0.0], [0.2, 2.0]


def _spaces(linear=True, disk=True):
    """The unit square under a linear band and the disk, in both packages."""
    jc, tc = [], []
    if linear:
        jc.append(jsp.LinearConstraint(jnp.asarray(A), jnp.asarray(LB), jnp.asarray(UB)))
        tc.append(convert.linear_constraint_from_numpy(A, LB, UB))
    if disk:
        jc.append(jsp.NonlinearConstraint(_jdisk, -100.0, 0.0))
        tc.append(tsp.NonlinearConstraint(_tdisk, -100.0, 0.0))
    jbox = jsp.Box([0.0, 0.0], [1.0, 1.0], constraints=jc)
    tbox = convert.box_from_numpy([0.0, 0.0], [1.0, 1.0], tc, device="cpu", dtype=F64)
    return jbox, tbox


def test_residuals_feasibility_shift_and_products_match_jax():
    jbox, tbox = _spaces()
    x = np.random.default_rng(0).uniform(size=(4, 5, 2))
    np.testing.assert_allclose(
        tbox.constraints_residuals(_t(x)).numpy(), _jit(jbox.constraints_residuals, x),
        rtol=RTOL, atol=1e-15)
    np.testing.assert_array_equal(tbox.is_feasible(_t(x)).numpy(), _jit(jbox.is_feasible, x))
    assert tbox.has_constraints and len(tbox.constraints) == 2
    # a shifted constraint reads its own dimensions of a wider space
    x4 = np.random.default_rng(1).uniform(size=(7, 4))
    for jc, tc in zip(jbox.constraints, tbox.constraints):
        np.testing.assert_allclose(tc.shift(1, 2, 4).residual(_t(x4)).numpy(),
                                   _jit(jc.shift(1, 2, 4).residual, x4), rtol=RTOL)
    # a product keeps both operands' constraints on its own dimensions
    jother, tother = _spaces(disk=False)
    jprod, tprod = jbox * jother, tbox * tother
    assert tprod.dimension == 4 and len(tprod.constraints) == 3
    np.testing.assert_allclose(tprod.constraints_residuals(_t(x4)).numpy(),
                               _jit(jprod.constraints_residuals, x4), rtol=RTOL)
    np.testing.assert_array_equal(tprod.is_feasible(_t(x4)).numpy(), _jit(jprod.is_feasible, x4))
    # the constraints live on the box's device and dtype, and move with it
    assert all(c.A.dtype == F64 for c in tbox.constraints if isinstance(c, tsp.LinearConstraint))
    assert tbox.to("cpu", torch.float32).constraints[0].A.dtype == torch.float32


def test_equality_and_repr_match_jax():
    jbox, tbox = _spaces(disk=False)
    jsame, tsame = _spaces(disk=False)
    assert (tbox == tsame) == (jbox == jsame) is True
    tc = convert.linear_constraint_from_numpy(A, LB, [0.3, 2.0])
    jc = jsp.LinearConstraint(jnp.asarray(A), jnp.asarray(LB), jnp.asarray([0.3, 2.0]))
    assert (tbox == convert.box_from_numpy([0, 0], [1, 1], [tc], device="cpu", dtype=F64)) == (
        jbox == jsp.Box([0.0, 0.0], [1.0, 1.0], constraints=[jc])) is False
    assert (tbox == tsp.Box([0.0, 0.0], [1.0, 1.0], device="cpu", dtype=F64)) is False
    assert tsame.constraints[0].shift(0, 2, 2) == tsame.constraints[0]  # onto all dims: itself
    assert convert.linear_constraint_from_numpy(A, LB, UB) == tsame.constraints[0]
    assert repr(tbox.constraints[0]).startswith("LinearConstraint(A=tensor(")
    # a nonlinear constraint equals only itself (in both packages)
    jd, td = _spaces(linear=False)
    assert (td == _spaces(linear=False)[1]) == (jd == _spaces(linear=False)[0]) is False
    assert td == tsp.Box([0.0, 0.0], [1.0, 1.0], td._constraints, device="cpu", dtype=F64)
    with pytest.raises(NotImplementedError):
        tsp.Box([0.0], [1.0], device="cpu").constraints_residuals(torch.zeros(1, 1))
    assert not tsp.Box([0.0], [1.0], device="cpu").has_constraints


@pytest.fixture
def jax_draws(monkeypatch):
    """Record the JAX package's seed pools (a box's uniforms), Halton points and fit
    restarts as it makes them, and make the port replay them: its box samples scale the
    uniforms, its Halton samples are the JAX points, its fits start from the restarts.
    Returns the three queues."""
    pools, haltons, restarts = [], [], []
    sample, halton, optimize = jsp.Box.sample, jsp.Box.sample_halton, JGPR.optimize

    def record_pool(self, key, n):
        pools.append(np.asarray(jax.random.uniform(key, (n, self.dimension), dtype=jnp.float64)))
        return sample(self, key, n)

    def record_halton(self, key, n):
        haltons.append(np.asarray(halton(self, key, n)))
        return jnp.asarray(haltons[-1])

    def record_fit(self, dataset):
        sub = jax.random.split(self._key)[1]
        restarts.append(np.asarray(_RANDOMIZE_STARTS(
            sub, self.params, self._num_kernel_samples, self._train_noise, priors=self._priors)))
        return optimize(self, dataset)

    def replay_pool(self, generator, n):
        u = pools.pop(0)
        assert u.shape == (n, self.dimension)
        return self._scale(_t(u))

    def replay_halton(self, generator, n):
        return _t(haltons.pop(0))

    def replay_fit(generator, params, X, Y, mask, *, num_starts, train_noise, max_iters, priors,
                pool_sharding):
        return ttrain.fit_gpr_from_starts(_t(restarts.pop(0)), params, X, Y, mask,
                                          train_noise=train_noise, max_iters=max_iters,
                                          priors=priors,
                                          pool_sharding=pool_sharding)

    monkeypatch.setattr(jsp.Box, "sample", record_pool)
    monkeypatch.setattr(jsp.Box, "sample_halton", record_halton)
    monkeypatch.setattr(JGPR, "optimize", record_fit)
    monkeypatch.setattr(tsp.Box, "sample", replay_pool)
    monkeypatch.setattr(tsp.Box, "sample_halton", replay_halton)
    monkeypatch.setattr(tgpr, "fit_gpr", replay_fit)
    return pools, haltons, restarts


def test_feasible_samplers_match_jax_on_its_draws(jax_draws):
    """Exactly the JAX package's points: the first ``n`` feasible ones in draw order, over
    as many tries as it took (the band and the disk keep about a fifth of the square)."""
    pools, haltons, _ = jax_draws
    jbox, tbox = _spaces()
    want = np.asarray(jbox.sample_feasible(jax.random.PRNGKey(4), 40))
    tries = len(pools)
    got = tbox.sample_feasible(None, 40)
    assert tries > 1 and not pools
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jbox.sample_halton_feasible(jax.random.PRNGKey(5), 40))
    assert len(haltons) > 1
    np.testing.assert_array_equal(tbox.sample_halton_feasible(None, 40).numpy(), want)
    assert not haltons
    # Sobol: each try continues the sequence where the last stopped
    np.testing.assert_array_equal(tbox.sample_sobol_feasible(40, skip=3).numpy(),
                                  np.asarray(jbox.sample_sobol_feasible(40, skip=3)))
    assert bool(tbox.is_feasible(got).all())


def test_feasible_sampling_times_out_and_passes_through():
    infeasible = convert.linear_constraint_from_numpy([[1.0, 1.0]], [5.0], [6.0])
    tbox = convert.box_from_numpy([0, 0], [1, 1], [infeasible], device="cpu", dtype=F64)
    gen = torch.Generator().manual_seed(0)
    for draw in (lambda: tbox.sample_feasible(gen, 4, max_tries=3),
                 lambda: tbox.sample_halton_feasible(gen, 4, max_tries=3),
                 lambda: tbox.sample_sobol_feasible(4, max_tries=3)):
        with pytest.raises(tsp.SampleTimeoutError, match="4 feasible points in 3 tries"):
            draw()
    plain = tsp.Box([0.0, 0.0], [1.0, 1.0], device="cpu", dtype=F64)
    a = plain.sample_feasible(torch.Generator().manual_seed(1), 5)
    np.testing.assert_array_equal(a.numpy(), plain.sample(torch.Generator().manual_seed(1), 5).numpy())


def _optimizer_case(case):
    """The JAX package's two unit cases (``tests/unit/test_optimizer.py:162-200``):
    spaces, and the acquisitions ``[..., V, D] -> [..., V]`` in both packages."""
    if case == "nonlinear":  # x + y <= 1; the unconstrained maximum (0.9, 0.9) is outside
        jc = jsp.NonlinearConstraint(lambda x: x[..., 0] + x[..., 1], 0.0, 1.0)
        tc = tsp.NonlinearConstraint(lambda x: x[..., 0] + x[..., 1], 0.0, 1.0)
        jacq = lambda x: -jnp.sum((x - 0.9) ** 2, -1)  # noqa: E731
        tacq = lambda x: -torch.sum((x - 0.9) ** 2, -1)  # noqa: E731
    else:  # |x - y| <= 0.1; the unconstrained maximum (1, 0) is outside
        jc = jsp.LinearConstraint(jnp.asarray([[1.0, -1.0]]), jnp.asarray([-0.1]), jnp.asarray([0.1]))
        tc = convert.linear_constraint_from_numpy([[1.0, -1.0]], [-0.1], [0.1])
        jacq = lambda x: x[..., 0] - x[..., 1] - jnp.sum((x - 0.5) ** 2, -1)  # noqa: E731
        tacq = lambda x: x[..., 0] - x[..., 1] - torch.sum((x - 0.5) ** 2, -1)  # noqa: E731
    jbox = jsp.Box([0.0, 0.0], [1.0, 1.0], constraints=[jc])
    tbox = convert.box_from_numpy([0, 0], [1, 1], [tc], device="cpu", dtype=F64)
    return jbox, tbox, jacq, tacq


@pytest.mark.parametrize("case", ["nonlinear", "linear"])
def test_constrained_optimizer_core_matches_jax(case):
    """From the JAX package's feasible seed pool: the same feasible-masked seed scores,
    the same penalized L-BFGS runs and the same winner (points and values at rtol 1e-9);
    the winner is feasible, and the nonlinear case's lies on its boundary at (0.5, 0.5)."""
    jbox, tbox, jacq, tacq = _optimizer_case(case)
    seeds = np.array(jbox.sample_feasible(jax.random.PRNGKey(1234), 256))[:, None, :]
    seeds[:8] = np.random.default_rng(3).uniform(size=(8, 1, 2))  # some infeasible seeds
    lower, upper = np.zeros((1, 2)), np.ones((1, 2))
    jpts, jv, jimp = jopt._optimize_continuous_core(
        Partial(jacq), jnp.asarray(seeds), jnp.asarray(lower), jnp.asarray(upper),
        jnp.zeros(2, bool), 8, 60, residual_fn=Partial(jbox.constraints_residuals))
    pts, v, imp = topt._optimize_continuous_core(
        tacq, _t(seeds), _t(lower), _t(upper), 8, 60, residual_fn=tbox.constraints_residuals)
    np.testing.assert_allclose(pts.numpy(), jpts, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), jv, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(imp.numpy(), jimp, rtol=1e-9, atol=1e-12)
    assert bool(tbox.is_feasible(pts).all())
    if case == "nonlinear":
        np.testing.assert_allclose(pts.numpy(), [[0.5, 0.5]], atol=2e-2)
    # the whole optimizer on the box: feasible seeds, a feasible point
    opt = topt.generate_continuous_optimizer(num_initial_samples=256, num_optimization_runs=8)
    point = opt(tbox, lambda x: tacq(x[..., 0, :])[..., None], generator=torch.Generator().manual_seed(0))
    assert bool(tbox.is_feasible(point).all())


def test_penalty_gradient_matches_jax_away_from_the_centre():
    """The exact penalty ``Σ relu(−r)²`` on ``ConstrainedScaledBranin``'s residuals and its
    gradient (the square root's gradient is infinite at the centre, as in the JAX
    package, so the points keep away from it)."""
    jspace = JConstrainedScaledBranin.search_space
    tspace = ConstrainedScaledBranin.search_space.to("cpu", F64)
    x = np.random.default_rng(5).uniform(size=(30, 2))
    x = x[np.linalg.norm(x - 0.5, axis=-1) > 0.05]

    def jpen(q):
        return jnp.sum(jnp.square(jax.nn.relu(-jspace.constraints_residuals(q))))

    q = _t(x).requires_grad_(True)
    tpen = torch.sum(torch.square(torch.relu(-tspace.constraints_residuals(q))))
    (tg,) = torch.autograd.grad(tpen, q)
    np.testing.assert_allclose(tpen.item(), float(_jit(jpen, x)), rtol=1e-12)
    np.testing.assert_allclose(tg.numpy(), _jit(jax.grad(jpen), x), rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("smoothing", [None, "logistic"])
def test_fast_constraints_feasibility_matches_jax(smoothing):
    jbox, tbox = _spaces()
    jsmooth = None if smoothing is None else (lambda r: jax.nn.sigmoid(r / 0.05))
    tsmooth = None if smoothing is None else (lambda r: torch.sigmoid(r / 0.05))
    jfn = jfun.FastConstraintsFeasibility(jbox, jsmooth).prepare_acquisition_function(None)
    builder = tfun.FastConstraintsFeasibility(tbox, tsmooth)
    tfn = builder.prepare_acquisition_function(None)
    assert builder.update_acquisition_function(tfn, None) is tfn
    x = np.random.default_rng(6).uniform(size=(50, 1, 2))
    x[:, 0, 1] = x[:, 0, 0] + np.random.default_rng(7).uniform(-0.25, 0.25, size=50)  # by the band
    # values in [0, 1]: the two normal CDFs part in the far tails, below 1e-15
    np.testing.assert_allclose(tfn(_t(x)).numpy(), _jit(jfn, x), rtol=1e-9, atol=1e-15)
    q = _t(x).requires_grad_(True)
    (tg,) = torch.autograd.grad(tfn(q).sum(), q)
    jg = _jit(jax.grad(lambda z: jnp.sum(jfn(z))), x)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-8, atol=1e-12)
    with pytest.raises(NotImplementedError):
        tfun.fast_constraints_feasibility(tsp.Box([0.0], [1.0], device="cpu"))


def _branin_models(n=8, seed=0, capacity=None):
    """ScaledBranin data over the unit square (some of it outside the disk) and
    ``build_gpr`` over it in both packages (three fit restarts)."""
    X = np.random.default_rng(seed).uniform(size=(n, 2))
    Y = np.asarray(JConstrainedScaledBranin.objective(jnp.asarray(X)))
    cap = capacity or n
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y), capacity=cap)
    tds = Dataset.from_arrays(_t(X), _t(Y), capacity=cap)
    jspace = JConstrainedScaledBranin.search_space
    tspace = ConstrainedScaledBranin.search_space.to("cpu", F64)
    jmodel = jbuilders.build_gpr(jds, jspace, num_kernel_samples=3, optimize_key=jax.random.PRNGKey(9))
    tmodel = build_gpr(tds, tspace, num_kernel_samples=3)
    return (jspace, jds, jmodel), (tspace, tds, tmodel)


def test_feasible_incumbent_of_ei_and_eci_matches_jax():
    """EI over a constrained space takes the minimum posterior mean over the feasible
    observed points; ECI with the fast feasibility under the objective's tag multiplies
    EI over the feasible incumbent by the feasibility."""
    (jspace, jds, jmodel), (tspace, tds, tmodel) = _branin_models()
    feasible = np.array(jspace.is_feasible(jds.query_points))
    assert feasible.any() and not feasible.all()
    x = np.random.default_rng(8).uniform(size=(40, 1, 2))
    jei = jfun.ExpectedImprovement(jspace).prepare_acquisition_function(jmodel, jds)
    tei = tfun.ExpectedImprovement(tspace).prepare_acquisition_function(tmodel, tds)
    np.testing.assert_allclose(tei(_t(x)).numpy(), _jit(jei, x), rtol=1e-9, atol=1e-14)
    mean, _ = tmodel.predict(tds.query_points)
    np.testing.assert_allclose(float(tei.args[1]), float(mean[torch.as_tensor(feasible)].min()), rtol=1e-12)
    jeci = jfun.ExpectedConstrainedImprovement(
        OBJECTIVE, jfun.FastConstraintsFeasibility(jspace).using(OBJECTIVE))
    teci = tfun.ExpectedConstrainedImprovement(
        OBJECTIVE, tfun.FastConstraintsFeasibility(tspace).using(OBJECTIVE))
    jf = jeci.prepare_acquisition_function({OBJECTIVE: jmodel}, {OBJECTIVE: jds})
    tf = teci.prepare_acquisition_function({OBJECTIVE: tmodel}, {OBJECTIVE: tds})
    np.testing.assert_allclose(tf(_t(x)).numpy(), _jit(jf, x), rtol=1e-9, atol=1e-14)


def test_constrained_scaled_branin_has_a_lower_feasible_minimum_in_both_packages():
    """A fault of the reference, kept in the port for parity: ScaledBranin's minimizer
    (0.5428, 0.1517) lies inside the disk (residual 0.049) and is 4.9% below the declared
    minimum -0.99888."""
    point = [[0.5428, 0.1517]]
    jspace, tspace = JConstrainedScaledBranin.search_space, ConstrainedScaledBranin.search_space.to("cpu", F64)
    assert bool(jspace.is_feasible(jnp.asarray(point))[0]) and bool(tspace.is_feasible(_t(point))[0])
    np.testing.assert_allclose(tspace.constraints_residuals(_t(point)).numpy()[0, 1], 0.0491, atol=1e-4)
    jval = float(JConstrainedScaledBranin.objective(jnp.asarray(point))[0, 0])
    tval = float(ConstrainedScaledBranin.objective(_t(point))[0, 0])
    np.testing.assert_allclose(tval, jval, rtol=1e-12)
    np.testing.assert_allclose(tval, -1.04741, atol=1e-5)
    for problem in (JConstrainedScaledBranin, ConstrainedScaledBranin):
        assert tval < float(problem.minimum[0]) == -0.99888
    np.testing.assert_array_equal(ConstrainedScaledBranin.minimizers, JConstrainedScaledBranin.minimizers)


def test_gardner_design_is_the_jax_tests_draw():
    """``chip_smoke.GARDNER_DESIGN`` is the initial design of the JAX package's Gardner ECI
    test (``_run``: ``Box([0, 0], [6, 6]).sample(jax.random.split(PRNGKey(3))[0], 6)``)."""
    from chip_smoke import GARDNER_DESIGN

    k_init, _ = jax.random.split(jax.random.PRNGKey(3))
    want = np.asarray(jsp.Box([0.0, 0.0], [6.0, 6.0]).sample(k_init, 6))
    np.testing.assert_array_equal(np.asarray(GARDNER_DESIGN).reshape(6, 2), want)


N, R = 96, 3


def test_constrained_ei_through_the_loop_matches_jax_over_three_steps(jax_draws):
    """Three steps of EGO with ``ExpectedImprovement(space)`` on ``ConstrainedScaledBranin``
    through ``BayesianOptimizer.optimize`` in both packages: the JAX run first (its
    feasible seed pools, fit restarts and query points recorded), then the port's on those
    draws, its observer holding each point to the JAX package's and observing the latter.
    Every query point is feasible."""
    pools, _, restarts = jax_draws
    (jspace, jds, jmodel), (tspace, tds, tmodel) = _branin_models(n=6, seed=2, capacity=16)
    asked = []

    def jobserver(qp):
        asked.append(np.asarray(qp))
        return jobj.mk_observer(JConstrainedScaledBranin.objective)(qp)

    def tobserver(qp):
        want = asked.pop(0)
        np.testing.assert_allclose(qp.numpy(), want, atol=1e-6)
        return mk_observer(ConstrainedScaledBranin.objective)(_t(want))

    jresult = jt.BayesianOptimizer(jobserver, jspace).optimize(
        3, jds, jmodel, jrule.EfficientGlobalOptimization(
            jfun.ExpectedImprovement(jspace), optimizer=jopt.generate_continuous_optimizer(N, R)),
        key=jax.random.PRNGKey(5), track_state=False)
    tresult = BayesianOptimizer(tobserver, tspace).optimize(
        3, tds, tmodel, trule.EfficientGlobalOptimization(
            tfun.ExpectedImprovement(tspace), optimizer=topt.generate_continuous_optimizer(N, R)),
        track_state=False)
    assert jresult.is_ok and tresult.is_ok, tresult.final_result
    assert not pools and not restarts and not asked
    want, got = jresult.try_get_final_dataset(), tresult.try_get_final_dataset()
    assert len(got) == int(want.num_points) == 9
    np.testing.assert_allclose(got.trimmed_query_points.numpy(), np.asarray(want.trimmed_query_points), atol=1e-6)
    assert bool(tspace.is_feasible(got.trimmed_query_points[6:]).all())
