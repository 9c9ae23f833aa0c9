"""The port's pool mesh on ``torch.distributed`` (gloo, CPU): sharded equals unsharded,
and both equal the JAX package.

The counterpart of ``tests/unit/test_parallel.py``, case by case, with the port's own
cases beside them. Each world size (2 and 4 ranks) is one group of worker processes,
started once for the module: every rank runs every case twice, without a mesh and under
the mesh of all ranks, and writes both results. The workers are this file run as a
script, so they import torch and the port and nothing of JAX.

The parent process draws what the JAX package would draw (the GPR, SGPR and SVGP
restarts, the seed pools as a box's uniforms in draw order, the HMC chains' draws) and
hands it to the workers, which replay it into the port's run. While they run, the parent
computes the JAX package's results on the same inputs, unsharded, as the JAX test holds
its sharded results to; the tests hold each rank's sharded result to them at the JAX
test's tolerances.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
F64 = torch.float64
WORLD_SIZES = (2, 4)
CHILD_TIMEOUT = 240

GPR_KEY, OPT_KEY, HMC_KEY, SGPR_KEY, MULTI_KEY, CONSTRAINED_KEY = 1, 2, 3, 6, 23, 24
HYPER = ("matern52", 1.3, [0.3, 0.5], 1e-3, 0.2)  # the sparse fits' start
SPARSE_CAPACITY = 16
SPARSE_STARTS = 8  # the sparse models' 5 restarts rounded up on the JAX test's 8 devices
TIES = np.array([[1.0, 0.0], [3.0, 2.0], [3.0, 2.0], [2.0, 5.0], [0.5, 5.0], [3.0, 1.0],
                 [2.0, 0.0], [3.0, 5.0]])  # [8, V]: best values tied across the ranks' blocks


# -- the cases, run by every rank of a worker group ------------------------------------------


def _data(seed: int, n: int, d: int = 2):
    from trieste_tpu_torch.data import Dataset

    X = torch.as_tensor(np.random.default_rng(seed).uniform(size=(n, d)))
    return Dataset.from_arrays(X, torch.sum(torch.square(X - 0.4), -1, keepdim=True))


def _box(d: int, constraints=None):
    from trieste_tpu_torch.space import Box

    return Box([0.0] * d, [1.0] * d, constraints, dtype=F64, device="cpu")


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _multimodal(x):  # maximum inside the box
    x = x[..., 0, :]
    return (-torch.sum(torch.square(x - 0.3), -1, keepdim=True)
            + 0.1 * torch.sum(torch.cos(8 * x), -1, keepdim=True))


CENTRES = [[0.2, 0.7], [0.8, 0.3]]


def _multi_acq(x):  # [..., V, D] -> [..., V]: a different optimum per slice
    centre = torch.tensor(CENTRES, dtype=F64)
    return -torch.sum(torch.square(x - centre), -1) + 0.05 * torch.cos(9 * x).sum(-1)


def _quadratic_06(x):  # the unconstrained maximum (0.6, 0.6) is infeasible below
    return -torch.sum(torch.square(x[..., 0, :] - 0.6), -1, keepdim=True)


def _constrained_box():
    from trieste_tpu_torch.space import LinearConstraint

    return _box(2, [LinearConstraint(torch.tensor([[1.0, 1.0]], dtype=F64),
                                     torch.tensor([0.0], dtype=F64),
                                     torch.tensor([0.8], dtype=F64))])


def _twice(mesh, run):
    """``run()`` without a mesh, then under ``mesh``."""
    from trieste_tpu_torch.parallel import global_mesh

    base = run()
    with global_mesh(mesh):
        sharded = run()
    return {"base": base, "sharded": sharded}


@contextlib.contextmanager
def _replaced(owner, name, value):
    original = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, original)


def _replayed_pools(pools):
    """The port's ``Box.sample`` scales the JAX package's recorded uniforms, in order."""
    from trieste_tpu_torch.space import Box

    queue = list(pools)

    def replay(self, generator, n):
        u = torch.as_tensor(queue.pop(0), dtype=F64)
        assert u.shape == (n, self.dimension)
        return self._scale(u)

    return _replaced(Box, "sample", replay)


def case_rounding(mesh, inputs):
    from trieste_tpu_torch.parallel import (
        current_pool_sharding, get_global_mesh, global_mesh, round_to_mesh,
    )

    out = {"before": (get_global_mesh() is None, round_to_mesh(5), current_pool_sharding())}
    with global_mesh(mesh):
        out["inside"] = (get_global_mesh() is mesh, round_to_mesh(5), round_to_mesh(8),
                         round_to_mesh(9), current_pool_sharding() is not None)
    out["after"] = (get_global_mesh() is None, current_pool_sharding())
    return out


def case_fit_gpr(mesh, inputs):
    """``fit_gpr`` with 16 restarts, the JAX package's, replayed through
    ``randomize_starts``. The fit is MAP with the default priors, as the models fit: on
    this noise-free quadratic the likelihood alone has a flat ridge (large variance with
    long lengthscales), where two L-BFGS implementations stop at different points within
    their tolerance."""
    from trieste_tpu_torch.data import Dataset
    from trieste_tpu_torch.models.gp import default_gpr_params, default_priors, fit_gpr, training
    from trieste_tpu_torch.parallel import pool_sharding

    gpr = inputs["gpr"]
    ds = Dataset.from_arrays(torch.as_tensor(gpr["X"]), torch.as_tensor(gpr["Y"]))
    params = default_gpr_params(ds, _box(2))
    priors = default_priors(params.kernel)

    def run(sharding):
        starts = torch.as_tensor(gpr["starts"])
        with _replaced(training, "randomize_starts", lambda *args, **kwargs: starts):
            r = fit_gpr(_gen(1), params, ds.query_points, ds.observations, ds.mask,
                        num_starts=16, max_iters=60, pool_sharding=sharding, priors=priors)
        p = r.params
        return (r.loss, training.pack_params(p), r.all_losses,
                [p.kernel.variance, p.kernel.lengthscales, p.noise_variance, p.mean_constant])

    return {"base": run(None), "sharded": run(pool_sharding(mesh))}


def case_continuous_optimizer(mesh, inputs):
    from trieste_tpu_torch.acquisition.optimizer import generate_continuous_optimizer

    opt = generate_continuous_optimizer(num_initial_samples=128, num_optimization_runs=8)

    def run():
        with _replayed_pools(inputs["pools"]["optimizer"]):
            return opt(_box(3), _multimodal, generator=_gen(2))

    return _twice(mesh, run)


def case_bo_loop(mesh, inputs):
    from trieste_tpu_torch import BayesianOptimizer
    from trieste_tpu_torch.acquisition import EfficientGlobalOptimization
    from trieste_tpu_torch.acquisition.optimizer import generate_continuous_optimizer
    from trieste_tpu_torch.models.gp import build_gpr
    from trieste_tpu_torch.objectives import SimpleQuadratic, mk_observer

    space = SimpleQuadratic.search_space.to("cpu", F64)
    observer = mk_observer(SimpleQuadratic.objective)

    def run():
        g = _gen(7)
        ds = observer(space.sample(g, 5))
        model = build_gpr(ds, space, likelihood_variance=1e-5, num_kernel_samples=8,
                          optimize_generator=_gen(8))
        rule = EfficientGlobalOptimization(optimizer=generate_continuous_optimizer(
            num_initial_samples=128, num_optimization_runs=8))
        result = BayesianOptimizer(observer, space).optimize(
            2, ds, model, rule, track_state=False, generator=g)
        return result.try_get_final_dataset().trimmed_query_points

    return _twice(mesh, run)


def case_pcts(mesh, inputs):
    from trieste_tpu_torch.acquisition import (
        EfficientGlobalOptimization, ParallelContinuousThompsonSampling,
    )
    from trieste_tpu_torch.acquisition.optimizer import generate_continuous_optimizer
    from trieste_tpu_torch.models.gp import build_gpr
    from trieste_tpu_torch.objectives import SimpleQuadratic, mk_observer

    space = SimpleQuadratic.search_space.to("cpu", F64)
    ds = mk_observer(SimpleQuadratic.objective)(space.sample(_gen(9), 6))

    def run():
        model = build_gpr(ds, space, likelihood_variance=1e-5, optimize_generator=_gen(10))
        rule = EfficientGlobalOptimization(
            ParallelContinuousThompsonSampling(),
            optimizer=generate_continuous_optimizer(num_initial_samples=64,
                                                    num_optimization_runs=8),
            num_query_points=4,
        )
        return rule.acquire_single(space, model, ds, generator=_gen(11))

    return _twice(mesh, run)


def case_pool_rounding(mesh, inputs):
    from trieste_tpu_torch.acquisition.optimizer import generate_continuous_optimizer
    from trieste_tpu_torch.parallel import global_mesh

    opt = generate_continuous_optimizer(num_initial_samples=101, num_optimization_runs=5)
    with global_mesh(mesh):
        return opt(_box(2), lambda x: -torch.sum(torch.square(x[..., 0, :] - 0.6), -1,
                                                 keepdim=True), generator=_gen(12))


def _gp_on(ds, space):
    from trieste_tpu_torch.models.gp import build_gpr

    model = build_gpr(ds, space, likelihood_variance=1e-5)
    model.optimize(ds)
    return model


def case_mc_sample_axis(mesh, inputs):
    """Batch MC EI at 256 samples and MC EI at 250 (not a multiple of 4): over a pool
    (nothing sharded, as in JAX) and at a single batch, where the sample axis is sharded,
    with the gradient through the gather."""
    from trieste_tpu_torch.acquisition import (
        BatchMonteCarloExpectedImprovement, MonteCarloExpectedImprovement,
    )
    from trieste_tpu_torch.objectives import SimpleQuadratic, mk_observer

    space = SimpleQuadratic.search_space.to("cpu", F64)
    ds = mk_observer(SimpleQuadratic.objective)(space.sample(_gen(13), 6))
    model = _gp_on(ds, space)
    pool = space.sample(_gen(14), 12).reshape(4, 3, 2)

    def run():
        out = []
        for builder, B in ((BatchMonteCarloExpectedImprovement(256, generator=_gen(16)), 3),
                           (MonteCarloExpectedImprovement(250, generator=_gen(17)), 1)):
            fn = builder.prepare_acquisition_function(model, ds)
            xg = pool[0, :B].clone().requires_grad_(True)
            value = fn(xg)
            (grad,) = torch.autograd.grad(value.sum(), xg)
            out += [fn(pool[:, :B]), value.detach(), grad]
        return out

    return _twice(mesh, run)


def case_hmc_chains(mesh, inputs):
    """8 chains of 5 samples after 10 warmup transitions, on the JAX package's draws."""
    from trieste_tpu_torch.data import Dataset
    from trieste_tpu_torch.models.gp import build_gpr_mcmc
    from trieste_tpu_torch.models.gp import mcmc

    hmc = inputs["hmc"]
    ds = Dataset.from_arrays(torch.as_tensor(hmc["X"]), torch.as_tensor(hmc["Y"]))
    draws = tuple(torch.as_tensor(d) for d in hmc["draws"])

    def replay(generator, chains, total, u0):
        assert (chains, total, u0.shape[0]) == (8, 15, draws[0].shape[1])
        return draws

    def run():
        model = build_gpr_mcmc(ds, _box(2), num_chains=8, num_samples_per_chain=5,
                               num_warmup=10, optimize_generator=_gen(3))
        with _replaced(mcmc, "_draw_chains", replay):
            results = model.optimize(ds)
        p = model.params_stack
        return [p.kernel.variance, p.kernel.lengthscales, p.noise_variance, p.mean_constant,
                results.accept_rate, results.step_size]

    return _twice(mesh, run)


def case_sgpr_restarts(mesh, inputs):
    """SGPR through ``optimize`` under the mesh (5 restarts rounded up) against the same
    model given the rounded count unsharded."""
    from trieste_tpu_torch.models.gp import build_sgpr
    from trieste_tpu_torch.parallel import global_mesh, round_to_mesh

    ds = _data(19, 30)

    def run(num_starts):
        model = build_sgpr(ds, _box(2), num_inducing_points=6, optimize_generator=_gen(20))
        model._num_starts = num_starts
        result = model.optimize(ds)
        p = model._params
        return [result.loss, result.all_losses, p.kernel.variance, p.kernel.lengthscales,
                p.inducing_points]

    with global_mesh(mesh):
        rounded = round_to_mesh(5)
        sharded = run(5)
    return {"base": run(rounded), "sharded": sharded, "rounded": rounded}


def case_svgp_restarts(mesh, inputs):
    """SVGP through ``optimize`` under the mesh (its 5 restarts rounded up) against
    ``fit_svgp`` at the rounded count unsharded, from the model's own restart draws."""
    from trieste_tpu_torch.models.gp import build_svgp
    from trieste_tpu_torch.models.gp.sparse import fit_svgp
    from trieste_tpu_torch.parallel import global_mesh, round_to_mesh

    ds = _data(21, 30)
    model = build_svgp(ds, _box(2), num_inducing_points=6, optimize_generator=_gen(22))
    start = model._params
    with global_mesh(mesh):
        rounded = round_to_mesh(5)
        model.optimize(ds)
    base = fit_svgp(_gen(0), start, ds.query_points, ds.observations, ds.mask,
                    train_noise=model._train_noise, max_iters=model._max_iters,
                    num_starts=rounded, priors=model._priors)
    return {
        "base": [base.params.kernel.variance, base.params.kernel.lengthscales, base.params.q_mu],
        "sharded": [model._params.kernel.variance, model._params.kernel.lengthscales,
                    model._params.q_mu],
        "rounded": rounded,
    }


def _sparse_fit(mesh, inputs, which):
    """The SGPR or SVGP fit (MAP, noise and inducing points fixed) from the JAX package's
    8 restarts, the models' 5 rounded up on the JAX test's 8-device mesh. (Trained
    inducing points leave SGPR's optimum flat: restarts reach it 1e-5 apart in the
    parameters, and the sparse parity tests hold that fit from one restart.)"""
    from trieste_tpu_torch import convert
    from trieste_tpu_torch.data import Dataset
    from trieste_tpu_torch.models.gp import sparse
    from trieste_tpu_torch.parallel import pool_sharding

    sp = inputs["sparse"]
    ds = Dataset.from_arrays(torch.as_tensor(sp["X"]), torch.as_tensor(sp["Y"]),
                             capacity=SPARSE_CAPACITY)
    priors = convert.priors_from_numpy(*sp["priors"], device="cpu", dtype=F64)
    starts = torch.as_tensor(sp[which])
    arrays = (ds.query_points, ds.observations, ds.mask)

    def run(sharding):
        if which == "sgpr":
            params = convert.sgpr_params_from_numpy(*HYPER, sp["Z"], device="cpu", dtype=F64)
            r = sparse.fit_sgpr_from_starts(starts, params, *arrays, train_noise=False,
                                            train_inducing=False, priors=priors,
                                            pool_sharding=sharding)
            extra = [r.all_losses]
        else:
            params = convert.svgp_params_from_numpy(*HYPER, sp["Z"], sp["q_mu"], sp["q_sqrt"],
                                                    device="cpu", dtype=F64)
            r = sparse.fit_svgp_from_starts(starts, params, *arrays, train_noise=False,
                                            priors=priors, pool_sharding=sharding)
            extra = [r.params.q_mu, r.params.q_sqrt]
        p = r.params
        return [r.loss, p.kernel.variance, p.kernel.lengthscales, p.mean_constant,
                p.noise_variance, p.inducing_points] + extra

    return {"base": run(None), "sharded": run(pool_sharding(mesh))}


def case_sgpr_fit(mesh, inputs):
    return _sparse_fit(mesh, inputs, "sgpr")


def case_svgp_fit(mesh, inputs):
    return _sparse_fit(mesh, inputs, "svgp")


def case_multi_space(mesh, inputs):
    from trieste_tpu_torch.acquisition.optimizer import generate_continuous_optimizer
    from trieste_tpu_torch.space import Box, TaggedMultiSearchSpace

    space = TaggedMultiSearchSpace([
        Box([0.0, 0.0], [0.5, 1.0], dtype=F64, device="cpu"),
        Box([0.5, 0.0], [1.0, 1.0], dtype=F64, device="cpu"),
    ])
    opt = generate_continuous_optimizer(num_initial_samples=128, num_optimization_runs=8)

    def run():
        with _replayed_pools(inputs["pools"]["multi_space"]):
            return opt(space, (_multi_acq, 2), generator=_gen(23))

    return _twice(mesh, run)


def case_constrained(mesh, inputs):
    from trieste_tpu_torch.acquisition.optimizer import generate_continuous_optimizer

    opt = generate_continuous_optimizer(num_initial_samples=128, num_optimization_runs=8)

    def run():
        with _replayed_pools(inputs["pools"]["constrained"]):
            return opt(_constrained_box(), _quadratic_06, generator=_gen(24))

    return _twice(mesh, run)


def case_sharded_best_ties(mesh, inputs):
    """``sharded_best`` over each rank's block of ``TIES`` (ties between the blocks): the
    global rows of the top 5 per column, of the argmax and of the argmin."""
    from trieste_tpu_torch.parallel import local_slice, sharded_best

    values = torch.as_tensor(TIES)
    rows = torch.arange(values.shape[0], dtype=F64)[:, None].expand(values.shape)
    block = local_slice(values.shape[0], mesh)
    top = sharded_best(values[block], rows[block], mesh, k=5)[1].T
    best = sharded_best(values[block], rows[block], mesh)[1][0]
    worst = sharded_best(values[block], rows[block], mesh, largest=False)[1][0]
    return [t.long() for t in (top, best, worst)]


def _gate_model():
    from trieste_tpu_torch.data import Dataset

    space = _box(2).to("cpu", torch.float32)
    X = torch.rand(20, 2, generator=_gen(25))
    ds = Dataset.from_arrays(X, torch.sum(torch.square(X - 0.4), -1, keepdim=True))
    return space, ds, _gp_on(ds, space)


@contextlib.contextmanager
def _fused_rows():
    """The plain version stands in for the kernel on the CPU; yields the row count of
    each fused call."""
    from trieste_tpu_torch.ops import fused_predict as fp

    rows = []
    original = fp.fused_predict_f

    def counted(params, cache, flat):
        rows.append(flat.shape[0])
        return original(params, cache, flat)

    with _replaced(fp, "CPU_PLAIN", True), _replaced(fp, "fused_predict_f", counted):
        yield rows


def case_gate(mesh, inputs):
    """An EI acquire over a 5000-row pool with the plain version standing in for the kernel
    on the CPU: the number of pool scores that take the fused path, the point, and EI
    there."""
    from trieste_tpu_torch.acquisition import EfficientGlobalOptimization, ExpectedImprovement
    from trieste_tpu_torch.acquisition.optimizer import generate_continuous_optimizer

    space, ds, model = _gate_model()
    ei = ExpectedImprovement().prepare_acquisition_function(model, ds)

    with _fused_rows() as rows:
        def run():
            rows.clear()
            rule = EfficientGlobalOptimization(optimizer=generate_continuous_optimizer(
                num_initial_samples=5000, num_optimization_runs=8))
            point = rule.acquire_single(space, model, ds, generator=_gen(26))
            return [point, len(rows)]

        out = _twice(mesh, run)
    for label in ("base", "sharded"):
        out[label].append(ei(out[label][0][:, None, :]))
    return out


def case_gate_other_rows(mesh, inputs):
    """An acquisition that predicts 1100 rows of its own (a grid, not the pool) each time
    it scores: the gate counts the pool's block as the whole pool, and the grid as its
    1100 rows (2200 or 4400 if it were counted as a block), as without a mesh. Yields
    the row counts of the fused calls."""
    from trieste_tpu_torch.acquisition import ExpectedImprovement
    from trieste_tpu_torch.acquisition.optimizer import generate_continuous_optimizer
    from trieste_tpu_torch.parallel import global_mesh

    space, ds, model = _gate_model()
    ei = ExpectedImprovement().prepare_acquisition_function(model, ds)
    grid = torch.rand(1100, 2, generator=_gen(30))

    def acq(x):
        model.predict(grid)
        return ei(x)

    opt = generate_continuous_optimizer(num_initial_samples=5000, num_optimization_runs=8)
    out = {}
    with _fused_rows() as rows:
        for label, m in (("base", None), ("sharded", mesh)):
            rows.clear()
            with global_mesh(m):
                opt(space, acq, generator=_gen(26))
            out[label] = list(rows)
    return out


def case_rows_scored(mesh, inputs):
    """The rows of the seed pool each rank scores: the loud check that the pool is
    sharded (the JAX test reads the sharding from the compiled HLO)."""
    from trieste_tpu_torch.acquisition.optimizer import generate_continuous_optimizer
    from trieste_tpu_torch.parallel import global_mesh

    rows = []

    def acq(x):
        rows.append(x.shape[0])
        return _multimodal(x)

    opt = generate_continuous_optimizer(num_initial_samples=128, num_optimization_runs=8)
    out = {}
    for label, m in (("base", None), ("sharded", mesh)):
        rows.clear()
        with global_mesh(m):
            opt(_box(3), acq, generator=_gen(27))
        out[label] = rows[0]
    return out


def _counting_collectives():
    """Wrap ``torch.distributed``'s collectives to count their calls."""
    import torch.distributed as dist

    count = {"n": 0}
    names = ("all_gather", "all_gather_into_tensor", "all_reduce", "broadcast", "reduce",
             "gather", "scatter", "reduce_scatter", "all_to_all", "barrier",
             "all_gather_object", "broadcast_object_list")
    originals = {n: getattr(dist, n) for n in names if hasattr(dist, n)}

    def wrap(fn):
        def counted(*args, **kwargs):
            count["n"] += 1
            return fn(*args, **kwargs)
        return counted

    for n, fn in originals.items():
        setattr(dist, n, wrap(fn))
    return count, lambda: [setattr(dist, n, fn) for n, fn in originals.items()]


def case_one_rank_group(mesh, inputs):
    """A mesh over the first rank alone (every rank makes its group): the optimizer and
    a GPR fit under it equal the unsharded run bit for bit, with no collective call."""
    from trieste_tpu_torch.acquisition.optimizer import generate_continuous_optimizer
    from trieste_tpu_torch.parallel import create_mesh

    one = create_mesh(1)
    if one.rank is None:
        return {"member": False, "size": one.size}
    opt = generate_continuous_optimizer(num_initial_samples=128, num_optimization_runs=8)
    ds = _data(28, 12)

    def run():
        model = _gp_on(ds, _box(2))
        return [opt(_box(3), _multimodal, generator=_gen(29)), model.params.kernel.lengthscales]

    count, restore = _counting_collectives()
    try:
        out = _twice(one, run)
    finally:
        restore()
    return dict(out, member=True, size=one.size, collectives=count["n"])


CASES = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


def _worker(world: int, rank: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from trieste_tpu_torch.parallel import create_mesh

    deadline = time.monotonic() + CHILD_TIMEOUT
    while not os.path.exists(inputs):  # the parent writes them while the ranks start
        assert time.monotonic() < deadline, "no inputs"
        time.sleep(0.05)
    given = torch.load(inputs, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        mesh = create_mesh()
        results = {name: fn(mesh, given) for name, fn in CASES.items()}
        results["jax_imported"] = "jax" in sys.modules
        assert not results["jax_imported"], "a rank imported jax"
        torch.save(results, out)
    finally:
        dist.destroy_process_group()


# -- the JAX package's side, in the parent process ------------------------------------------


def _jax_spaces():
    from trieste_tpu import space as jsp

    constraint = jsp.LinearConstraint(np.array([[1.0, 1.0]]), np.array([0.0]), np.array([0.8]))
    return {
        "optimizer": jsp.Box([0.0] * 3, [1.0] * 3),
        "multi_space": jsp.TaggedMultiSearchSpace([jsp.Box([0.0, 0.0], [0.5, 1.0]),
                                                   jsp.Box([0.5, 0.0], [1.0, 1.0])]),
        "constrained": jsp.Box([0.0, 0.0], [1.0, 1.0], [constraint]),
    }


def _jax_acquisitions():
    import jax.numpy as jnp

    def multimodal(x):
        x = x[..., 0, :]
        return (-jnp.sum(jnp.square(x - 0.3), -1, keepdims=True)
                + 0.1 * jnp.sum(jnp.cos(8 * x), -1, keepdims=True))

    def multi(x):
        return -jnp.sum(jnp.square(x - jnp.asarray(CENTRES)), -1) + 0.05 * jnp.cos(9 * x).sum(-1)

    def quadratic_06(x):
        return -jnp.sum(jnp.square(x[..., 0, :] - 0.6), -1, keepdims=True)

    return {"optimizer": (multimodal, OPT_KEY), "multi_space": ((multi, 2), MULTI_KEY),
            "constrained": (quadratic_06, CONSTRAINED_KEY)}


def _jax_sparse_starts(key, u0, n_shift, priors):
    """The ``SPARSE_STARTS`` restarts the JAX package's sparse fits draw from ``key`` (two
    lengthscales), drawn from ``priors`` or shifting the first ``n_shift`` entries."""
    import jax
    import jax.numpy as jnp

    from trieste_tpu.models.gp import priors as jpri

    @jax.jit
    def draw(key, u0, priors):
        if priors is not None:
            log_var, log_ls = jpri.sample_log_params(key, priors, SPARSE_STARTS - 1, 2)
            rest = jnp.broadcast_to(u0[None], (SPARSE_STARTS - 1, u0.shape[0]))
            rest = rest.at[:, 0].set(log_var).at[:, 1:3].set(log_ls)
            return jnp.concatenate([u0[None], rest])
        shifts = jax.random.uniform(key, (SPARSE_STARTS - 1, u0.shape[0]), dtype=u0.dtype,
                                    minval=-1.5, maxval=1.5)
        keep = jnp.zeros_like(u0, bool).at[:n_shift].set(True).at[3].set(False)
        return jnp.concatenate([u0[None], u0[None] + shifts * keep[None, :]])

    return np.asarray(draw(key, u0, priors))


def _jax_setup():
    """The inputs every rank replays (the JAX package's draws and the data), and the JAX
    objects whose results :func:`_jax_results` computes."""
    import jax
    import jax.numpy as jnp

    from trieste_tpu import space as jsp
    from trieste_tpu.data import Dataset as JDataset
    from trieste_tpu.models.gp import builders as jbuild
    from trieste_tpu.models.gp import priors as jpri
    from trieste_tpu.models.gp import sparse as js
    from trieste_tpu.models.gp import training as jtrain
    from trieste_tpu.objectives import ScaledBranin
    from trieste_tpu.ops.kernels import stationary as jstationary

    def problem(seed, n):
        X = np.random.default_rng(seed).uniform(size=(n, 2))
        return X, np.sum(np.square(X - 0.4), -1, keepdims=True)

    inputs, jax_side = {}, {}
    X, Y = problem(0, 20)
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y))
    jp = jbuild.default_gpr_params(jds, jsp.Box([0.0, 0.0], [1.0, 1.0]))
    jpr = jpri.default_priors(jp.kernel)
    key = jax.random.PRNGKey(GPR_KEY)
    starts = jax.jit(lambda k, p, pr: jtrain.randomize_starts(k, p, 16, priors=pr))
    inputs["gpr"] = {"X": X, "Y": Y, "starts": np.asarray(starts(key, jp, jpr))}
    jax_side["gpr"] = (key, jp, jpr, jds)

    # the seed pools: the uniforms of every box sample the optimizer's seeds draw
    pools, sample = {}, jsp.Box.sample
    for name, space in _jax_spaces().items():
        recorded = pools[name] = []

        def record(self, key, n, recorded=recorded):
            recorded.append(np.asarray(jax.random.uniform(key, (n, self.dimension),
                                                          dtype=jnp.float64)))
            return sample(self, key, n)

        jsp.Box.sample = record
        try:
            draw = space.sample_feasible if name == "constrained" else space.sample
            draw(jax.random.PRNGKey(_jax_acquisitions()[name][1]), 128)
        finally:
            jsp.Box.sample = sample
    inputs["pools"] = pools

    # the HMC chains: what ``_run_chains`` draws from the model's key
    X, Y = problem(18, 10)
    U = X.shape[1] + 3  # the packed variance, lengthscales, noise and mean

    @jax.jit
    def chain_draws(key):
        """``(jitter [8, U], momenta [15, 8, U], uniforms [15, 8])``, as ``_run_chains``
        draws them from the key ``optimize`` splits off."""
        k_init, k_chains = jax.random.split(jax.random.split(key)[1])

        def transition(k):
            k_mom, k_acc = jax.random.split(k)
            return (jax.random.normal(k_mom, (U,), jnp.float64),
                    jax.random.uniform(k_acc, dtype=jnp.float64))

        momenta, uniforms = jax.vmap(lambda k: jax.vmap(transition)(jax.random.split(k, 15)))(
            jax.random.split(k_chains, 8))
        jitter = 0.5 * jax.random.normal(k_init, (8, U), jnp.float64)
        return jitter, jnp.swapaxes(momenta, 0, 1), jnp.swapaxes(uniforms, 0, 1)

    key = jax.random.PRNGKey(HMC_KEY)  # the model's optimize_key
    inputs["hmc"] = {"X": X, "Y": Y, "draws": tuple(np.asarray(d) for d in chain_draws(key))}
    jax_side["hmc"] = (X, Y, key)

    # the sparse fits: ScaledBranin at 16 points, four inducing points, MAP, noise fixed
    X = np.random.default_rng(0).uniform(size=(SPARSE_CAPACITY, 2))
    Y = np.asarray(ScaledBranin.objective(jnp.asarray(X)))
    Z = np.random.default_rng(2).uniform(size=(4, 2))
    rng = np.random.default_rng(1)
    q_mu, q_sqrt = rng.normal(size=(4, 1)), np.tril(rng.normal(size=(1, 4, 4)))
    kind, var, ls, noise, mean = HYPER
    jsg = js.SGPRParams(jstationary(kind, var, jnp.asarray(ls), dtype=jnp.float64),
                        jnp.asarray(noise), jnp.asarray(mean), jnp.asarray(Z))
    jsv = js.SVGPParams(jsg.kernel, jsg.noise_variance, jsg.mean_constant, jsg.inducing_points,
                        jnp.asarray(q_mu), jnp.asarray(q_sqrt))
    jpr = jpri.default_priors(jsg.kernel, 1.0)
    sg_u0 = js._sgpr_pack(jsg, False, False)
    sv_u0 = js._sgpr_pack(jsv, False, False)
    inputs["sparse"] = {
        "X": X, "Y": Y, "Z": Z, "q_mu": q_mu, "q_sqrt": q_sqrt,
        "priors": tuple(np.asarray(p) for p in (jpr.ls_loc, jpr.var_loc, jpr.scale)),
        "sgpr": _jax_sparse_starts(jax.random.PRNGKey(SGPR_KEY), sg_u0, 4, jpr),
        "svgp": _jax_sparse_starts(jax.random.PRNGKey(0), sv_u0, sv_u0.shape[0], jpr),
    }
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y), capacity=SPARSE_CAPACITY)
    jax_side["sparse"] = (jsg, jsv, jpr, jds)
    return inputs, jax_side


def _jax_results(jax_side):
    """The JAX package's results on the inputs, unsharded, as numpy."""
    import jax
    import jax.numpy as jnp

    from trieste_tpu import space as jsp
    from trieste_tpu.acquisition import optimizer as jopt
    from trieste_tpu.data import Dataset as JDataset
    from trieste_tpu.models.gp import mcmc as jmcmc
    from trieste_tpu.models.gp import sparse as js
    from trieste_tpu.models.gp import training as jtrain

    np_ = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
    refs = {}
    key, jp, jpr, jds = jax_side["gpr"]
    fit = jtrain.fit_gpr(key, jp, jds.query_points, jds.observations, jds.mask, num_starts=16,
                         max_iters=60, priors=jpr)
    k = fit.params.kernel
    refs["fit_gpr"] = np_([fit.loss, fit.all_losses]) + [
        np_([k.variance, k.lengthscales, fit.params.noise_variance, fit.params.mean_constant])]

    opt = jopt.generate_continuous_optimizer(num_initial_samples=128, num_optimization_runs=8)
    for name, space in _jax_spaces().items():
        acq, seed = _jax_acquisitions()[name]
        refs[name] = np.asarray(opt(space, acq, jax.random.PRNGKey(seed)))

    X, Y, key = jax_side["hmc"]
    jds = JDataset.from_arrays(jnp.asarray(X), jnp.asarray(Y))
    jm = jmcmc.build_gpr_mcmc(jds, jsp.Box([0.0, 0.0], [1.0, 1.0]), num_chains=8,
                              num_samples_per_chain=5, num_warmup=10, optimize_key=key)
    result = jm.optimize(jds)
    p = jm.params_stack
    refs["hmc"] = np_([p.kernel.variance, p.kernel.lengthscales, p.noise_variance,
                       p.mean_constant, result.accept_rate, result.step_size])

    jsg, jsv, jpr, jds = jax_side["sparse"]
    arrays = (jds.query_points, jds.observations, jds.mask)

    def sparse_ref(r, extra=()):
        q = r.params
        return np_([r.loss, q.kernel.variance, q.kernel.lengthscales, q.mean_constant,
                    q.noise_variance, q.inducing_points, *extra])

    sg = js._jit_sgpr_fit(jax.random.PRNGKey(SGPR_KEY), jsg, *arrays, jpr, SPARSE_STARTS, False,
                          False, 100, None)
    refs["sgpr"] = sparse_ref(sg, (sg.all_losses,))
    sv = js._jit_svgp_fit(jsv, *arrays, jpr, False, 100, SPARSE_STARTS, None)
    refs["svgp"] = sparse_ref(sv, (sv.params.q_mu, sv.params.q_sqrt))

    values = jnp.asarray(TIES)
    refs["ties"] = np_([jax.lax.top_k(values.T, 5)[1], jnp.argmax(values, 0),
                        jnp.argmin(values, 0)])
    return refs


# -- the tests -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs():
    """Every world size's results, rank by rank (one group of workers per size, all
    started at once), and the JAX package's, computed while they run."""
    import jax

    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    jax.config.update("jax_disable_most_optimizations", True)  # compiling dominates
    with tempfile.TemporaryDirectory() as tmp:
        given = os.path.join(tmp, "inputs.pt")
        outs = {w: [os.path.join(tmp, f"w{w}r{r}.pt") for r in range(w)] for w in WORLD_SIZES}
        procs = {w: [subprocess.Popen(
            [sys.executable, __file__, str(w), str(r), os.path.join(tmp, f"store{w}"), given,
             outs[w][r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO,
        ) for r in range(w)] for w in WORLD_SIZES}
        try:
            inputs, jax_side = _jax_setup()
            torch.save(inputs, given + ".part")
            os.replace(given + ".part", given)
            refs = _jax_results(jax_side)
            logs = {w: [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in ps]
                    for w, ps in procs.items()}
        finally:
            jax.config.update("jax_disable_most_optimizations", False)
            for p in (p for ps in procs.values() for p in ps):
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for w in WORLD_SIZES:
            for r, (p, log) in enumerate(zip(procs[w], logs[w])):
                assert p.returncode == 0, f"rank {r} of {w} failed:\n{log[-4000:]}"
        results = {w: [torch.load(o, weights_only=False) for o in outs[w]] for w in WORLD_SIZES}
    return {"ranks": results, "jax": refs}


@pytest.fixture(scope="module")
def ranks(runs):
    return runs["ranks"]


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs["jax"]


def _close(a, b, **tol):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, **tol)
    elif isinstance(a, torch.Tensor):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)
    else:
        assert a == b


def _each_rank(ranks, world, case):
    """Every rank's result of ``case``; the ranks agree on the sharded result bit for bit."""
    out = [r[case] for r in ranks[world]]
    for other in out[1:]:
        _close(other["sharded"], out[0]["sharded"], rtol=0, atol=0)
    return out


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_mesh_context_and_rounding(ranks, world):
    for r in ranks[world]:
        rounded = -(-5 // world) * world
        assert r["rounding"]["before"] == (True, 5, None)
        assert r["rounding"]["inside"] == (True, rounded, 8, -(-9 // world) * world, True)
        assert r["rounding"]["after"] == (True, None)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_fit_gpr_sharded_matches_unsharded(ranks, world):
    for r in _each_rank(ranks, world, "fit_gpr"):
        (bl, bp, ball, _), (sl, sp, sall, _) = r["base"], r["sharded"]
        _close(sl, bl, rtol=1e-6)
        _close(sp, bp, rtol=1e-5, atol=1e-8)
        assert sall.shape == (16,)
        _close(sall, ball, rtol=1e-6)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_fit_gpr_sharded_matches_jax(ranks, jax_ref, world):
    """From the JAX package's 16 restarts: the loss and the parameters at the JAX test's
    tolerances. (A restart that stops at the 60 iterations short of an optimum lands
    where rounding takes it in either package, so the losses of every restart are held
    between sharded and unsharded, above, and not to the JAX package's.)"""
    loss, _, params = jax_ref["fit_gpr"]
    for r in _each_rank(ranks, world, "fit_gpr"):
        sl, _, _, sparams = r["sharded"]
        _close(sl, loss, rtol=1e-6)
        _close(sparams, params, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_continuous_optimizer_sharded_matches_unsharded(ranks, world):
    for r in _each_rank(ranks, world, "continuous_optimizer"):
        _close(r["sharded"], r["base"], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("world", WORLD_SIZES)
@pytest.mark.parametrize("case", ["continuous_optimizer", "multi_space", "constrained"])
def test_optimizer_sharded_matches_jax(ranks, jax_ref, world, case):
    """The JAX package's seed pool replayed: the point at the JAX test's tolerance."""
    want = jax_ref["optimizer" if case == "continuous_optimizer" else case]
    for r in _each_rank(ranks, world, case):
        _close(r["sharded"], want, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_bo_loop_sharded_matches_unsharded(ranks, world):
    for r in _each_rank(ranks, world, "bo_loop"):
        assert r["base"].shape == (7, 2)
        _close(r["sharded"], r["base"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_pcts_sharded_matches_unsharded(ranks, world):
    for r in _each_rank(ranks, world, "pcts"):
        assert r["base"].shape == (4, 2)
        _close(r["sharded"], r["base"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_optimizer_rounds_pools_to_mesh(ranks, world):
    """101 seeds and 5 runs do not divide over the ranks: they are rounded up."""
    points = [r["pool_rounding"] for r in ranks[world]]
    for p in points:
        np.testing.assert_allclose(p.numpy(), np.full((1, 2), 0.6), atol=1e-3)
        _close(p, points[0], rtol=0, atol=0)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_mc_sample_axis_sharded_matches_unsharded(ranks, world):
    for r in _each_rank(ranks, world, "mc_sample_axis"):
        _close(r["sharded"], r["base"], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_hmc_chains_sharded_matches_unsharded(ranks, world):
    for r in _each_rank(ranks, world, "hmc_chains"):
        _close(r["sharded"], r["base"], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_hmc_chains_sharded_match_jax(ranks, jax_ref, world):
    """On the JAX package's draws: the thinned stack, accept rates and step sizes."""
    for r in _each_rank(ranks, world, "hmc_chains"):
        _close(r["sharded"], jax_ref["hmc"], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_sgpr_restarts_sharded_match_unsharded(ranks, world):
    for r in _each_rank(ranks, world, "sgpr_restarts"):
        assert r["rounded"] == -(-5 // world) * world
        assert r["sharded"][1].shape == (r["rounded"],)
        _close(r["sharded"], r["base"], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_svgp_restarts_sharded_match_unsharded(ranks, world):
    for r in _each_rank(ranks, world, "svgp_restarts"):
        assert r["rounded"] == -(-5 // world) * world
        _close(r["sharded"], r["base"], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("world", WORLD_SIZES)
@pytest.mark.parametrize("which", ["sgpr", "svgp"])
def test_sparse_fits_sharded_match_jax(ranks, jax_ref, world, which):
    """From the JAX package's 8 restarts: the loss (and SGPR's loss of every restart) at
    rtol 1e-6 and the parameters at 1e-5, as the sparse parity tests hold the unsharded
    fits; sharded equals unsharded."""
    for r in _each_rank(ranks, world, f"{which}_fit"):
        got, want = r["sharded"], jax_ref[which]
        _close(got[0], want[0], rtol=1e-6, atol=1e-9)
        _close(got[1:6], want[1:6], rtol=1e-5, atol=1e-8)
        if which == "sgpr":
            assert got[6].shape == (SPARSE_STARTS,)
            _close(got[6], want[6], rtol=1e-6, atol=1e-9)
        else:
            _close(got[6:], want[6:], rtol=1e-5, atol=1e-8)
        _close(r["sharded"], r["base"], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_sharded_best_breaks_ties_as_jax(ranks, jax_ref, world):
    """The top 5, the argmax and the argmin over the ranks' blocks pick the rows that
    ``jax.lax.top_k``, ``argmax`` and ``argmin`` pick over the whole array."""
    for r in ranks[world]:
        for got, want in zip(r["sharded_best_ties"], jax_ref["ties"]):
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_multi_space_optimizer_sharded_matches_unsharded(ranks, world):
    for r in _each_rank(ranks, world, "multi_space"):
        assert r["base"].shape == (2, 2)
        _close(r["sharded"], r["base"], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_constrained_optimizer_sharded_matches_unsharded(ranks, world):
    for r in _each_rank(ranks, world, "constrained"):
        assert float(r["base"].sum()) <= 0.8 + 1e-7
        _close(r["sharded"], r["base"], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_fused_gate_follows_the_global_pool(ranks, world):
    """5000 rows on 4 ranks are 1250 a rank, under the 2048-row gate: the pool score
    still takes the fused path, as it does unsharded. The plain float32 version stands in
    for the kernel here, and its products round by row count (2e-7 apart between 1250
    and 5000 rows), so near-equal seeds may start other runs that end elsewhere on the
    flat top of EI: the point is held to 1e-3, as the pool-rounding case holds it, and its
    EI to no less than the unsharded point's within 1e-4."""
    for r in _each_rank(ranks, world, "gate"):
        (base_point, base_calls, base_ei), (point, calls, ei) = r["base"], r["sharded"]
        assert base_calls == calls == 1
        assert float(ei) >= float(base_ei) * (1 - 1e-4)
        _close(point, base_point, atol=1e-3)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_fused_gate_counts_other_queries_as_their_own_rows(ranks, world):
    for r in ranks[world]:
        assert r["gate_other_rows"]["base"] == [5000]
        assert r["gate_other_rows"]["sharded"] == [5000 // world]


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_each_rank_scores_its_block_of_the_pool(ranks, world):
    for r in ranks[world]:
        assert r["rows_scored"]["base"] == 128
        assert r["rows_scored"]["sharded"] == 128 // world


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_one_rank_group_runs_no_collective_and_equals_unsharded(ranks, world):
    members = [r["one_rank_group"] for r in ranks[world] if r["one_rank_group"]["member"]]
    assert len(members) == 1 and members[0]["size"] == 1
    assert members[0]["collectives"] == 0
    _close(members[0]["sharded"], members[0]["base"], rtol=0, atol=0)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_workers_import_no_jax(ranks, world):
    assert not any(r["jax_imported"] for r in ranks[world])


def test_initialize_multi_host_takes_one_device_per_rank():
    from trieste_tpu_torch.parallel import initialize_multi_host

    with pytest.raises(ValueError, match="one device"):
        initialize_multi_host("localhost:1", 2, 0, local_device_count=4, device="cpu")


def test_initialize_multi_host_binds_the_rank_to_its_device(monkeypatch):
    """The rank's CUDA device becomes the process's current device before the group
    starts (so ``"cuda"`` is the rank's own card); NCCL for a CUDA device, gloo for the
    CPU, unless the caller names the backend."""
    import torch.distributed as dist

    from trieste_tpu_torch.parallel import initialize_multi_host

    events = []
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: events.append(torch.device(d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kwargs: events.append((backend, kwargs)))
    join = dict(init_method="tcp://host0:29500", world_size=8)

    monkeypatch.setenv("LOCAL_RANK", "1")
    initialize_multi_host("host0:29500", 8, 5)
    assert events == [torch.device("cuda", 1), ("nccl", dict(join, rank=5))]
    events.clear()
    monkeypatch.delenv("LOCAL_RANK")
    initialize_multi_host("host0:29500", 8, 3)
    assert events == [torch.device("cuda", 3), ("nccl", dict(join, rank=3))]
    events.clear()
    initialize_multi_host("host0:29500", 8, 2, backend="gloo", device="cuda:0")
    assert events == [torch.device("cuda", 0), ("gloo", dict(join, rank=2))]
    events.clear()
    initialize_multi_host("host0:29500", 8, 4, device="cpu")
    assert events == [("gloo", dict(join, rank=4))]


def test_sharded_pool_counts_only_views_of_the_block(monkeypatch):
    """Under ``sharded_pool(block, 4)`` a view of the block counts four times its rows;
    another tensor of the same rows keeps its own count."""
    from trieste_tpu_torch.ops import fused_predict as fp

    monkeypatch.setattr(fp, "CPU_PLAIN", True)
    _, _, model = _gate_model()
    params, cache = model.params, model.posterior_cache
    seeds = torch.rand(5000, 1, 2, generator=_gen(31))
    block = seeds[1250:2500]
    other = block.clone()[:, 0]
    assert not fp.can_fuse(params, cache, block[:, 0])
    with fp.sharded_pool(block, 4):
        assert fp.can_fuse(params, cache, block[:, 0])
        assert fp.can_fuse(params, cache, block.reshape(-1, 2))
        assert not fp.can_fuse(params, cache, other)
    assert not fp.can_fuse(params, cache, block[:, 0])


def test_create_mesh_without_a_group_is_one_rank():
    from trieste_tpu_torch.parallel import create_mesh

    mesh = create_mesh()
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    with pytest.raises(ValueError, match="requested 2 devices"):
        create_mesh(2)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
