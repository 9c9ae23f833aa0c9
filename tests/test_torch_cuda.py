"""The CUDA kernel of the port on the card: it builds, launches, matches its plain version
within the TPU kernel's contract, and serves the fused path of ``predict_f``.

These tests need a CUDA device and skip without one. The machine with the card has no JAX,
which ``tests/conftest.py`` imports, so run them there with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import pytest
import torch

from trieste_tpu_torch.models.gp import posterior as tpost
from trieste_tpu_torch.ops import fused_predict as fp
from trieste_tpu_torch.ops.kernels import stationary

pytestmark = pytest.mark.cuda

MEAN_TOL = dict(rtol=1e-3, atol=3e-4)
VAR_TOL = dict(rtol=5e-3, atol=3e-4)


@pytest.fixture()
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _state(kind, C, P, device, dtype=torch.float32, seed=0, D=4):
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.rand(C, D, generator=g, dtype=torch.float64, device=device)
    Y = torch.cos(X @ torch.randn(D, P, generator=g, dtype=torch.float64, device=device))
    mask = torch.arange(C, device=device) < C - C // 4
    params = tpost.GPRParams(
        kernel=stationary(kind, 1.3, [0.5 + 0.1 * d for d in range(D)], dtype=torch.float64,
                          device=device),
        noise_variance=torch.tensor(1e-3, dtype=torch.float64, device=device),
        mean_constant=torch.tensor(0.1, dtype=torch.float64, device=device),
    )
    cache = tpost.build_cache(params, X * mask[:, None], Y * mask[:, None], mask)
    cast = lambda t: t.to(dtype)  # noqa: E731
    params = params.replace(
        kernel=params.kernel.replace(variance=cast(params.kernel.variance),
                                     lengthscales=cast(params.kernel.lengthscales)),
        noise_variance=cast(params.noise_variance), mean_constant=cast(params.mean_constant),
    )
    cache = cache.replace(X=cast(cache.X), L=cast(cache.L), alpha=cast(cache.alpha),
                          LinvT=cast(cache.LinvT))
    return params, cache, g


# (kind, C, P, N, D): every kind at three capacities; then, one kind each, the edges of the
# kernel's 32-row k tiles and 128-column panels (C), of its 64-row warpgroups and 128-row
# blocks (N), and input dimensions that are odd (padded to even), 1, above 8 (candidate rows
# in shared memory) or above 96 (candidate and training rows read from global memory)
_EDGE_C = (8, 9, 31, 127, 128, 129, 255, 256, 257, 513)
_EDGE_N = (1, 63, 64, 65, 127, 129)
_EDGE_D = (1, 2, 3, 5, 7, 8, 9, 12, 20, 129, 300)
_SHAPES = [(kind, C, P, 4099, 4) for kind in fp.KINDS for C, P in [(100, 1), (1000, 2), (1024, 8)]]
_SHAPES += [(fp.KINDS[i % 4], C, 1, 4099, 4) for i, C in enumerate(_EDGE_C)]
_SHAPES += [(fp.KINDS[i % 4], 100, 2, N, 4) for i, N in enumerate(_EDGE_N)]
_SHAPES += [(fp.KINDS[i % 4], 100, 1, 1000, D) for i, D in enumerate(_EDGE_D)]


@pytest.mark.parametrize("kind, C, P, N, D", _SHAPES)
def test_kernel_matches_plain_version(device, kind, C, P, N, D):
    params, cache, g = _state(kind, C, P, device, D=D)
    flat = torch.rand(N, D, generator=g, device=device)
    args = fp.operands(params, cache, flat)
    mean, var = fp.launch(*args)
    torch.cuda.synchronize()
    want_mean, want_var = fp.fused_predict_reference(args[0], *(t.double() for t in args[1:]))
    torch.testing.assert_close(mean.double(), want_mean, **MEAN_TOL)
    torch.testing.assert_close(var.double(), want_var, **VAR_TOL)


@pytest.mark.parametrize("k, C, D", [(0, 64, 6), (1, 64, 6), (4, 64, 6), (5, 64, 6), (9, 64, 6),
                                     (37, 64, 6), (300, 1024, 6), (1023, 1024, 6),
                                     (37, 64, 129), (300, 1024, 300)])
def test_one_hot_operands_pin_the_fragment_layout(device, k, C, D):
    """``alpha = e_k`` gives ``mean[i] = K[i, k] + m``; a ``LinvT`` whose only non-zero row
    is ``k`` gives ``var[i] = σ² − K[i, k]²·Σ_j LinvT[k, j]²``: permuted rows or k indices
    of the tensor-core fragments would show in row ``i``."""
    g = torch.Generator(device=device).manual_seed(k)
    scale = (6 / D) ** 0.5  # r² of the same order at every D
    spread = torch.linspace(0.25, 1.75, 257, device=device)[:, None]  # and rows that differ
    xs = scale * spread * torch.rand(257, D, generator=g, device=device)
    A = scale * torch.rand(C, D, generator=g, device=device)
    alpha = torch.zeros(C, 1, device=device)
    alpha[k] = 1.0
    LinvT = torch.zeros(C, C, device=device)
    LinvT[k, k:] = torch.randn(C - k, generator=g, device=device) / (C - k) ** 0.5
    scal = torch.tensor([1.7, 0.25], device=device)
    mean, var = fp.launch("rbf", xs, A, alpha, LinvT, scal)
    torch.cuda.synchronize()
    want_mean, want_var = fp.fused_predict_reference(
        "rbf", xs.double(), A.double(), alpha.double(), LinvT.double(), scal.double()
    )
    assert want_var.max() - want_var.min() > 0.1  # the rows differ, so a permutation shows
    torch.testing.assert_close(mean.double(), want_mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(var.double(), want_var, rtol=1e-5, atol=2e-6)


def test_pack_writes_only_the_tiles_on_or_above_the_diagonal(device):
    params, cache, g = _state("rbf", 1024, 1, device)
    _, _, A, alpha, LinvT, _ = fp.operands(params, cache, torch.rand(8, 4, generator=g, device=device))
    packed = fp.pack(A, alpha, LinvT)
    # the 8 panels of 128 columns hold 4, 8, ..., 32 k tiles of 32 rows: hi and lo tiles of
    # 32 x 128 floats with the tile's 32 rows of A (D = 4) and alpha (P = 1)
    assert packed.numel() == 144 * (2 * 32 * 128 + 32 * 4 + 32 * 1)
    hi = packed[: 32 * 128]
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)  # TF32: the low 13 bits are zero
    assert float(hi.abs().sum()) > 0.0


def test_predict_f_launches_the_kernel_and_grads_flow(device):
    params, cache, g = _state("matern52", 512, 1, device)
    x = torch.rand(fp.MIN_POINTS + 5, 4, generator=g, device=device, requires_grad=True)
    before = fp.launches
    mean, var = tpost.predict_f(params, cache, x)
    assert fp.launches == before + 1
    ref_mean, ref_var = tpost.predict_f_reference(params, cache, x)
    torch.testing.assert_close(mean, ref_mean, **MEAN_TOL)
    torch.testing.assert_close(var, ref_var, **VAR_TOL)
    (g_fused,) = torch.autograd.grad(mean.sum() + var.sqrt().sum(), x)
    (g_ref,) = torch.autograd.grad(ref_mean.sum() + ref_var.sqrt().sum(), x)
    # both backwards are the exact path's, but grad(sqrt(v)) weights the cotangent by
    # 1/sqrt(v) of each forward, two fp32 computations of a variance that is small near
    # the data: the tolerance of tests/unit/test_fused_predict.py:82 for the same reason
    torch.testing.assert_close(g_fused, g_ref, rtol=1e-2, atol=1e-3)


def test_gram_refuses_tf32_matmuls(device):
    kernel = stationary("rbf", 1.0, [0.5], dtype=torch.float32, device=device)
    x = torch.rand(16, 1, device=device)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            kernel(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert kernel(x).shape == (16, 16)


def test_launch_rejects_what_the_kernel_does_not_take(device):
    params, cache, g = _state("rbf", 64, 1, device)
    args = fp.operands(params, cache, torch.rand(100, 4, generator=g, device=device))
    with pytest.raises(ValueError, match="float32"):
        fp.launch(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        fp.launch(args[0], args[1], args[2], args[3], args[4].T, args[5])
    with pytest.raises(ValueError, match="shape mismatch"):
        fp.launch(args[0], args[1][:, :3].contiguous(), *args[2:])
    with pytest.raises(ValueError, match="unsupported sizes"):
        fp.launch(args[0], torch.zeros(100, 0, device=device),
                  torch.zeros(64, 0, device=device), *args[3:])


# -- Ask/Tell, batch and Monte-Carlo acquisition, Thompson sampling on the card ---------


def _fitted_branin(device, n=24):
    from trieste_tpu_torch.models.gp import build_gpr
    from trieste_tpu_torch.objectives import ScaledBranin, mk_observer

    space = ScaledBranin.search_space
    observer = mk_observer(ScaledBranin.objective)
    gen = torch.Generator(device=device).manual_seed(0)
    data = observer(space.sample(gen, n))
    model = build_gpr(data, space, num_kernel_samples=2)
    model.optimize(data)
    return space, observer, gen, data, model


def _rules():
    from trieste_tpu_torch import acquisition as acq

    small = acq.generate_continuous_optimizer(num_initial_samples=4096, num_optimization_runs=4)
    return {
        "batch-mc-ei": lambda: acq.EfficientGlobalOptimization(
            acq.BatchMonteCarloExpectedImprovement(64), small, num_query_points=2),
        "analytic-qei": lambda: acq.EfficientGlobalOptimization(
            acq.BatchExpectedImprovement(32), small, num_query_points=2),
        "mc-ei": lambda: acq.EfficientGlobalOptimization(acq.MonteCarloExpectedImprovement(64), small),
        "mc-aei": lambda: acq.EfficientGlobalOptimization(
            acq.MonteCarloAugmentedExpectedImprovement(64), small),
        "pcts": lambda: acq.EfficientGlobalOptimization(
            acq.ParallelContinuousThompsonSampling(), small, num_query_points=2),
        "greedy-cts": lambda: acq.EfficientGlobalOptimization(
            acq.GreedyContinuousThompsonSampling(), small, num_query_points=2),
        "dts-exact": lambda: acq.DiscreteThompsonSampling(500, 2),
        "dts-trajectory": lambda: acq.DiscreteThompsonSampling(
            500, 2, acq.ThompsonSamplerFromTrajectory()),
        "random": lambda: acq.RandomSampling(2),
        "async": lambda: acq.AsynchronousOptimization(
            acq.BatchMonteCarloExpectedImprovement(64), small, num_query_points=2),
        "async-greedy": lambda: acq.AsynchronousGreedy(
            acq.GreedyContinuousThompsonSampling(), small, num_query_points=2),
        "lp": lambda: acq.EfficientGlobalOptimization(
            acq.LocalPenalization(_BRANIN_SPACE()), small, num_query_points=2),
        "fantasizer": lambda: acq.EfficientGlobalOptimization(
            acq.Fantasizer(), small, num_query_points=2),
        "gibbon": lambda: acq.EfficientGlobalOptimization(
            acq.GIBBON(_BRANIN_SPACE()), small, num_query_points=2),
        "mes": lambda: acq.EfficientGlobalOptimization(
            acq.MinValueEntropySearch(_BRANIN_SPACE()), small),
        "monlcb": lambda: acq.EfficientGlobalOptimization(
            acq.MultipleOptimismNegativeLowerConfidenceBound(_BRANIN_SPACE()), small,
            num_query_points=2),
        "ivr": lambda: acq.EfficientGlobalOptimization(
            acq.IntegratedVarianceReduction(_BRANIN_SPACE().sample_sobol(64)), small),
    }


def _BRANIN_SPACE():
    from trieste_tpu_torch.objectives import ScaledBranin

    return ScaledBranin.search_space


@pytest.mark.parametrize("name", sorted(_rules()))
def test_ask_tell_stays_on_the_card(device, name):
    from trieste_tpu_torch import AskTellOptimizer

    space, observer, gen, data, model = _fitted_branin(device)
    opt = AskTellOptimizer(space, data, model, _rules()[name](), generator=gen, fit_model=False)
    points = opt.ask()
    assert points.is_cuda and points.shape[-1] == 2 and bool(space.contains(points).all())
    opt.tell(observer(points))
    assert opt.dataset.query_points.is_cuda and len(opt.dataset) == 24 + points.shape[0]
    restored = AskTellOptimizer.from_state(opt.to_state(), space, _rules()[name](), generator=gen)
    assert restored.ask().is_cuda


def test_samplers_and_posterior_functions_stay_on_the_card(device):
    from trieste_tpu_torch.acquisition import sampler as tts
    from trieste_tpu_torch.models.gp import sampler as tsam

    space, observer, gen, data, model = _fitted_branin(device)
    x = space.sample(gen, 12).reshape(3, 4, 2)
    outputs = [
        *model.predict_joint(x), *model.predict_y(x), model.sample(gen, x, 5),
        model.covariance_between_points(x, x[0]),
        *model.conditional_predict_f(x, observer(x[0])),
        model.conditional_predict_f_sample(gen, x, observer(x[0]), 5),
        tsam.BatchReparametrizationSampler(8, model).sample(x, generator=gen),
        tsam.IndependentReparametrizationSampler(8, model).sample(x, generator=gen),
        tsam.DecoupledTrajectorySampler(model, 128).get_trajectory(gen, 4)(x),
        model.trajectory_sampler().get_trajectory(gen, 4)(x),
        tts.GumbelSampler().sample(model, 5, x[0], generator=gen),
        tts.ExactThompsonSampler().sample(model, 5, x.reshape(-1, 2), generator=gen),
        space.sample_halton(gen, 8), space.sample_sobol(8),
    ]
    for out in outputs:
        assert out.is_cuda and bool(torch.isfinite(out).all())


def test_a_generator_on_the_wrong_device_raises(device):
    from trieste_tpu_torch import AskTellOptimizer
    from trieste_tpu_torch.models.gp import sampler as tsam

    space, observer, gen, data, model = _fitted_branin(device)
    cpu_gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="generator is on cpu"):
        AskTellOptimizer(space, data, model, generator=cpu_gen, fit_model=False)
    with pytest.raises(ValueError, match="generator is on cpu"):
        _rules()["dts-exact"]().acquire_single(space, model, data, generator=cpu_gen)
    with pytest.raises(ValueError, match="generator is on cpu"):
        model.trajectory_sampler().get_trajectory(cpu_gen, 2)
    with pytest.raises(ValueError, match="generator is on cpu"):
        tsam.BatchReparametrizationSampler(4, model).sample(data.query_points[:3], generator=cpu_gen)


def test_monte_carlo_ei_seed_scoring_launches_the_kernel(device):
    from trieste_tpu_torch.acquisition import MonteCarloExpectedImprovement

    space, observer, gen, data, model = _fitted_branin(device)
    acq = MonteCarloExpectedImprovement(128).prepare_acquisition_function(model, data)
    pool = space.sample(gen, 5000)[:, None, :]
    before = fp.launches
    with torch.no_grad():
        scores = acq(pool)
    assert fp.launches == before + 1 and scores.shape == (5000, 1) and scores.is_cuda
    few = pool[:64].clone().requires_grad_(True)  # the optimizer's small batches: exact path
    before = fp.launches
    torch.autograd.grad(acq(few).sum(), few)
    assert fp.launches == before


def test_monlcb_pool_through_the_kernel_matches_the_exact_fp64_path(device):
    """MONLCB's ``[N, V, D]`` seed pool flattens to N·V rows, which pass the kernel's gate
    though N alone would not; the scores agree with the exact fp64 prediction within the
    kernel's contract pushed through ``−(mean − beta·std)``."""
    from trieste_tpu_torch.acquisition import MultipleOptimismNegativeLowerConfidenceBound
    from trieste_tpu_torch.acquisition.function.function import _monlcb_fn_spread

    space, observer, gen, data, model = _fitted_branin(device)
    fn = MultipleOptimismNegativeLowerConfidenceBound(space).prepare_acquisition_function(model)
    N, V = 1024, 3
    assert N < fp.MIN_POINTS <= N * V
    pool = space.sample(gen, N)[:, None, :].expand(N, V, 2)
    before = fp.launches
    with torch.no_grad():
        got = fn(pool).double()
    assert fp.launches == before + 1 and got.shape == (N, V)
    params = model.params
    p64 = params.replace(
        kernel=params.kernel.replace(variance=params.kernel.variance.double(),
                                     lengthscales=params.kernel.lengthscales.double()),
        noise_variance=params.noise_variance.double(), mean_constant=params.mean_constant.double())
    c64 = tpost.build_cache(p64, data.query_points.double(), data.observations.double(), data.mask,
                            with_linvt=False)
    predict64 = lambda x: tpost.predict_f_reference(p64, c64, x)  # noqa: E731
    want = _monlcb_fn_spread(predict64, 2.0, pool.double())
    mean64, var64 = predict64(pool.double())
    spread = 0.5 + 0.5 * torch.arange(1, V + 1, dtype=torch.float64, device=device) / (V + 1)
    betas = 5.0 * 2.0 * torch.special.ndtri(spread)  # as the function takes them, D = 2
    limit = (MEAN_TOL["atol"] + MEAN_TOL["rtol"] * mean64[..., 0].abs()
             + betas.abs() * torch.sqrt(VAR_TOL["atol"] + VAR_TOL["rtol"] * var64[..., 0]))
    assert bool(((got - want).abs() <= limit).all())


def test_conditional_marginal_at_full_pool_size_matches_the_joint_form(device):
    """At 131072 queries the conditioned marginal needs O(B·(C + M)) memory (the
    ``[B, B]`` block alone would be 68.7 GB in fp32); on its first 4096 rows it equals the
    diagonal of the joint form."""
    space, observer, gen, data, model = _fitted_branin(device)
    q = space.sample(gen, 131072)
    extra = observer(space.sample(gen, 2))
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    mean, var = model.conditional_predict_f(q, extra)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < 1e9
    jmean, jcov = model.conditional_predict_joint(q[:4096], extra)
    torch.testing.assert_close(mean[:4096], jmean, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(var[:4096, 0], torch.diagonal(jcov[0]), rtol=1e-4, atol=1e-5)
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())


# -- trust regions on the card ------------------------------------------------------------


def _small_trust_region_rules():
    from trieste_tpu_torch import acquisition as acq

    small = acq.generate_continuous_optimizer(num_initial_samples=4096, num_optimization_runs=4)
    space = _BRANIN_SPACE()
    return {
        "trego": lambda: acq.BatchTrustRegionBox([acq.TREGOBox(space)],
                                                 acq.EfficientGlobalOptimization(optimizer=small)),
        "turbo": lambda: acq.BatchTrustRegionBox([acq.TURBOBox(space)],
                                                 [acq.EfficientGlobalOptimization(optimizer=small)]),
        "batch-tr": lambda: acq.BatchTrustRegionBox(3, acq.EfficientGlobalOptimization(
            acq.MultipleOptimismNegativeLowerConfidenceBound(space), small, num_query_points=3)),
    }


@pytest.mark.parametrize("name", sorted(_small_trust_region_rules()))
def test_trust_region_fleet_state_on_the_card_copies_and_saves(device, name, tmp_path):
    """A fleet's regions keep their tensors and generators on the card; the state survives
    a deep copy, ``Record.save`` and ``OptimizationResult.from_path``, and a restored
    generator goes on drawing as the original does."""
    import copy

    from trieste_tpu_torch import AskTellOptimizer, OptimizationResult, Record
    from trieste_tpu_torch.acquisition import BatchTrustRegionState

    space, observer, gen, data, model = _fitted_branin(device)
    opt = AskTellOptimizer(space, data, model, _small_trust_region_rules()[name](), generator=gen,
                           fit_model=False)
    points = opt.ask()
    assert points.is_cuda and points.ndim == 3 and bool(space.contains(points.reshape(-1, 2)).all())
    opt.tell(observer(points.reshape(-1, 2)))
    state = opt.acquisition_state
    assert isinstance(state, BatchTrustRegionState)
    for region in state.subspaces:
        assert region.lower.is_cuda and region.location.is_cuda
        assert getattr(region, "_generator", gen).device.type == "cuda"
    copied = copy.deepcopy(state)
    result = OptimizationResult(None, [Record(opt.datasets, opt.models, state)])
    result.save(tmp_path)
    loaded = OptimizationResult.from_path(tmp_path).history[0].acquisition_state
    for original, again in zip(state.subspaces, loaded.subspaces):
        torch.testing.assert_close(again.lower, original.lower, rtol=0, atol=0)
        torch.testing.assert_close(again.location, original.location, rtol=0, atol=0)
        assert again.location.is_cuda
    region, twin = state.subspaces[0], copied.subspaces[0]
    if hasattr(region, "_generator"):
        assert torch.equal(torch.rand(4, generator=region._generator, device=device),
                           torch.rand(4, generator=twin._generator, device=device))
    restored = AskTellOptimizer.from_state(opt.to_state(copy=True), space,
                                           _small_trust_region_rules()[name](), generator=gen)
    assert restored.ask().is_cuda


def test_mask_to_region_on_the_card_matches_the_cpu(device):
    from trieste_tpu_torch import Dataset
    from trieste_tpu_torch.acquisition.trust_region import _mask_to_region

    g = torch.Generator(device=device).manual_seed(3)
    X = torch.rand(1000, 6, generator=g, device=device)
    ds = Dataset.from_arrays(X, X.sum(-1, keepdim=True), capacity=1024)
    inside = (X[:, 0] > 0.3) & (X[:, 1] < 0.8)
    inside = torch.cat([inside, torch.zeros(24, dtype=torch.bool, device=device)])
    got = _mask_to_region(ds, inside)
    cpu = Dataset(ds.query_points.cpu(), ds.observations.cpu(), ds.num_points)
    want = _mask_to_region(cpu, inside.cpu())
    assert got.capacity == 1024 and got.num_points == want.num_points == int(inside.sum())
    torch.testing.assert_close(got.query_points.cpu(), want.query_points, rtol=0, atol=0)
    torch.testing.assert_close(got.observations.cpu(), want.observations, rtol=0, atol=0)


def test_kernel_on_a_trust_region_fleet_seed_pool(device):
    """The seed pool of a ten-region fleet, ``[131072, 10, 6]`` (each region's rows in its
    own box), flattened to 1,310,720 rows: the kernel against its fp64 plain version, in
    chunks of the plain version."""
    from trieste_tpu_torch.space import Box, TaggedMultiSearchSpace

    params, cache, g = _state("matern52", 1024, 1, device, D=6)
    lower = torch.rand(10, 6, generator=g, device=device) * 0.5
    fleet = TaggedMultiSearchSpace([Box(lo, lo + 0.3, device=device) for lo in lower])
    pool = fleet.sample(g, 131072)
    assert pool.shape == (131072, 10, 6) and bool(fleet.contains(pool).all())
    args = fp.operands(params, cache, pool.reshape(-1, 6))
    mean, var = fp.launch(*args)
    torch.cuda.synchronize()
    assert mean.shape[0] == 1310720
    for rows in torch.split(torch.arange(1310720, device=device), 131072):
        want_mean, want_var = fp.fused_predict_reference(
            args[0], args[1][rows].double(), *(t.double() for t in args[2:]))
        torch.testing.assert_close(mean[rows].double(), want_mean, **MEAN_TOL)
        torch.testing.assert_close(var[rows].double(), want_var, **VAR_TOL)


def _dtlz2_stack(device, stack_type=None):
    """A two-member stack of exact GPs on 1000 DTLZ2(6, 2) points (capacity 1024), with
    default-noise hyperparameters (no fit)."""
    from trieste_tpu_torch import Dataset
    from trieste_tpu_torch.models import TrainableModelStack
    from trieste_tpu_torch.models.gp import build_gpr
    from trieste_tpu_torch.objectives import DTLZ2, mk_observer

    problem = DTLZ2(6, 2)
    space = problem.search_space.to(device)
    gen = torch.Generator(device=device).manual_seed(6)
    data = mk_observer(problem.objective)(space.sample(gen, 1000))
    qp, obs = data.trimmed_query_points, data.trimmed_observations
    members = [(build_gpr(Dataset.from_arrays(qp, obs[:, i:i + 1]), space), 1) for i in range(2)]
    return space, gen, data, (stack_type or TrainableModelStack)(*members)


def test_stack_ehvi_on_a_full_pool_matches_the_exact_fp64_path(device):
    """EHVI of a two-member stack over 131,072 seeds: one launch per member, each member's
    prediction within the kernel's contract of the exact fp64 one, and the scores within
    that contract pushed through EHVI (to first order in each member's mean and std, with
    a factor of two)."""
    from trieste_tpu_torch.acquisition import ExpectedHypervolumeImprovement
    from trieste_tpu_torch.acquisition.function.multi_objective import _ehvi_fn

    space, gen, data, stack = _dtlz2_stack(device)
    fn = ExpectedHypervolumeImprovement().prepare_acquisition_function(stack, data)
    pool = space.sample(gen, 131072)[:, None, :]
    before = fp.launches
    with torch.no_grad():
        got = fn(pool).double()
    assert fp.launches == before + 2 and got.shape == (131072, 1)
    members64 = []
    for m in stack.models:
        p = m.params
        p64 = p.replace(kernel=p.kernel.replace(variance=p.kernel.variance.double(),
                                                lengthscales=p.kernel.lengthscales.double()),
                        noise_variance=p.noise_variance.double(),
                        mean_constant=p.mean_constant.double())
        c64 = tpost.build_cache(p64, m.dataset.query_points.double(),
                                m.dataset.observations.double(), m.dataset.mask,
                                with_linvt=False)
        members64.append((p64, c64))
        mean32, var32 = tpost.predict_f(p, m.posterior_cache, pool[:, 0])
        mean64, var64 = tpost.predict_f_reference(p64, c64, pool[:, 0].double())
        torch.testing.assert_close(mean32.double(), mean64, **MEAN_TOL)
        torch.testing.assert_close(var32.double(), var64, **VAR_TOL)

    def predict64(x):
        outs = [tpost.predict_f_reference(p, c, x) for p, c in members64]
        return torch.cat([o[0] for o in outs], -1), torch.cat([o[1] for o in outs], -1)

    lower, upper = (t.double() for t in fn.args[1:])
    mean, var = (t.detach().requires_grad_(True) for t in predict64(pool[:, 0].double()))
    want = _ehvi_fn(lambda x: (mean, var), lower, upper, pool.double())
    g_mean, g_var = torch.autograd.grad(want.sum(), (mean, var))
    std = torch.sqrt(var.detach())
    d_var = VAR_TOL["atol"] + VAR_TOL["rtol"] * var.detach()
    d_std = torch.sqrt(var.detach() + d_var) - torch.sqrt(torch.clamp_min(var.detach() - d_var, 0.0))
    g_std = 2.0 * std * g_var  # d/dstd through var = std²
    limit = 2.0 * torch.sum(g_mean.abs() * (MEAN_TOL["atol"] + MEAN_TOL["rtol"] * mean.detach().abs())
                            + g_std.abs() * d_std, -1, keepdim=True) + 1e-6
    assert bool(((got - want.detach()).abs() <= limit).all())


def test_stack_sampler_on_the_card_copies_and_saves(device, tmp_path):
    """A stack's reparametrization sampler frozen from a CUDA generator: a deep copy and a
    record saved and loaded again sample as it does, on the card."""
    import copy

    from trieste_tpu_torch import OptimizationResult, Record
    from trieste_tpu_torch.models import HasReparamSamplerModelStack

    space, gen, data, stack = _dtlz2_stack(device, HasReparamSamplerModelStack)
    sampler = stack.reparam_sampler(16)
    x = space.sample(gen, 3)
    first = sampler.sample(x, generator=torch.Generator(device=device).manual_seed(1))
    assert first.shape == (16, 3, 2) and first.is_cuda
    assert all(s._eps.is_cuda for s in sampler._samplers)
    twin = copy.deepcopy(sampler)
    torch.testing.assert_close(twin.sample(x), first, rtol=0, atol=0)
    OptimizationResult(None, [Record({"OBJECTIVE": data}, {"OBJECTIVE": stack}, (sampler, gen))]
                       ).save(tmp_path)
    loaded, loaded_gen = OptimizationResult.from_path(tmp_path).history[0].acquisition_state
    torch.testing.assert_close(loaded.sample(x), first, rtol=0, atol=0)
    assert loaded_gen.device.type == "cuda"
    assert torch.equal(torch.rand(4, generator=loaded_gen, device=device),
                       torch.rand(4, generator=gen, device=device))


def test_non_dominated_mask_on_the_card_matches_the_cpu(device):
    from trieste_tpu_torch.acquisition.multi_objective import non_dominated, non_dominated_mask

    g = torch.Generator(device=device).manual_seed(2)
    obs = torch.rand(2000, 3, generator=g, device=device)
    obs[1] = obs[0]
    got = non_dominated_mask(obs)
    assert got.is_cuda
    assert torch.equal(got.cpu(), non_dominated_mask(obs.cpu()))
    front, mask = non_dominated(obs)
    assert front.is_cuda and torch.equal(front.cpu(), obs.cpu()[mask.cpu()])


def _constrained_box(device, dtype=torch.float32):
    from trieste_tpu_torch.space import Box, LinearConstraint, NonlinearConstraint

    disk = NonlinearConstraint(
        lambda x: torch.sqrt(torch.sum(torch.square(x - 0.5), dim=-1)) - 0.4, -100.0, 0.0)
    band = LinearConstraint(torch.tensor([[1.0, -1.0]]), -0.3, 0.3)
    return Box([0.0, 0.0], [1.0, 1.0], [disk, band], dtype=dtype, device=device)


def test_constraints_on_the_card_match_the_cpu(device):
    """Residuals and feasibility on the card against the CPU's on the same points, and the
    feasible sampler's points there: feasible, on the box's device and dtype, the first
    ``n`` feasible of its draws."""
    box = _constrained_box(device)
    x = torch.rand(4096, 2, generator=torch.Generator().manual_seed(0))
    cpu = _constrained_box("cpu")
    torch.testing.assert_close(box.constraints_residuals(x.to(device)).cpu(),
                               cpu.constraints_residuals(x), rtol=1e-6, atol=1e-6)
    assert torch.equal(box.is_feasible(x.to(device)).cpu(), cpu.is_feasible(x))
    assert box.constraints[1].A.device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(1)
    points = box.sample_feasible(gen, 5000)
    assert points.shape == (5000, 2) and points.device.type == "cuda"
    assert points.dtype == torch.float32 and bool(box.is_feasible(points).all())
    # the same draws, filtered on the CPU
    replay = torch.Generator(device=device).manual_seed(1)
    draws = torch.cat([box.sample(replay, 5000) for _ in range(8)]).cpu()
    torch.testing.assert_close(points.cpu(), draws[cpu.is_feasible(draws)][:5000])


def test_constrained_optimizer_point_is_feasible_on_the_card(device):
    from trieste_tpu_torch.acquisition.optimizer import generate_continuous_optimizer

    box = _constrained_box(device)
    opt = generate_continuous_optimizer(num_initial_samples=4096, num_optimization_runs=16)
    point = opt(box, lambda x: -torch.sum((x[..., 0, :] - 0.95) ** 2, dim=-1, keepdim=True),
                generator=torch.Generator(device=device).manual_seed(2))
    assert point.device.type == "cuda" and bool(box.is_feasible(point).all())


def _sparse_pair(device, model):
    """The same sparse model in fp64 on the CPU and in fp32 on the card."""
    from trieste_tpu_torch.data import Dataset
    from trieste_tpu_torch.models.gp import sparse as tsp
    from trieste_tpu_torch.ops.kernels import stationary as stat

    g = torch.Generator().manual_seed(3)
    X = torch.rand(300, 3, generator=g, dtype=torch.float64)
    Y = torch.sin(3.0 * X[:, :1]) + X[:, 1:2] * X[:, 2:]
    Z = torch.rand(40, 3, generator=g, dtype=torch.float64)
    made = []
    for dev, dtype in (("cpu", torch.float64), (device, torch.float32)):
        to = lambda t: t.to(device=dev, dtype=dtype)  # noqa: E731
        kernel = stat("matern52", 0.8, [0.4, 0.5, 0.6], dtype=dtype, device=dev)
        noise, mean = to(torch.tensor(1e-3)), to(torch.tensor(0.1))
        data = Dataset.from_arrays(to(X), to(Y))
        if model == "sgpr":
            made.append(tsp.SparseGaussianProcessRegression(
                tsp.SGPRParams(kernel, noise, mean, to(Z)), data))
        else:
            q = tsp.svgp_optimal_variational(
                tsp.SVGPParams(kernel, noise, mean, to(Z), to(torch.zeros(40, 1)),
                               to(torch.eye(40)[None])),
                data.query_points, data.observations, data.mask)
            made.append(tsp.SparseVariational(q, data))
    return made


@pytest.mark.parametrize("model", ["sgpr", "svgp"])
def test_sparse_predictions_in_fp32_on_the_card_match_fp64_on_the_cpu(device, model):
    """Within the contract of the fused kernel's variance (mean rtol 1e-3 / atol 3e-4,
    variance rtol 5e-3 / atol 3e-4)."""
    cpu, card = _sparse_pair(device, model)
    x = torch.rand(2000, 3, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    mean, var = card.predict(x.to(device, torch.float32))
    want_mean, want_var = cpu.predict(x)
    torch.testing.assert_close(mean.cpu().double(), want_mean, **MEAN_TOL)
    torch.testing.assert_close(var.cpu().double(), want_var, **VAR_TOL)
    jmean, jcov = card.predict_joint(x[:12].reshape(3, 4, 3).to(device, torch.float32))
    wmean, wcov = cpu.predict_joint(x[:12].reshape(3, 4, 3))
    torch.testing.assert_close(jmean.cpu().double(), wmean, **MEAN_TOL)
    torch.testing.assert_close(jcov.cpu().double(), wcov, **VAR_TOL)


def test_rejected_natural_gradient_step_in_fp32_reads_nothing_back(device):
    """A step of 4 from a narrow ``q`` (``S = 0.01·I``) leaves the positive-definite cone:
    its Cholesky fails, the step is rejected on the card and ``q`` stays, with no read
    from the device (a synchronizing call raises in the sync debug mode)."""
    from trieste_tpu_torch.data import Dataset
    from trieste_tpu_torch.models.gp import vgp as tvgp

    g = torch.Generator(device=device).manual_seed(0)
    X = 2 * torch.rand(40, 2, generator=g, device=device) - 1
    data = Dataset.from_arrays(X, (X.square().sum(-1, keepdim=True) > 0.5).float())
    params = tvgp.VGPParams(
        kernel=stationary("matern52", 1.0, [0.5, 0.5], device=device),
        mean_constant=torch.zeros((), device=device),
        q_mu=torch.randn(data.capacity, 1, generator=g, device=device),
        q_sqrt=0.1 * torch.eye(data.capacity, device=device),
    )
    args = (data.query_points, data.observations, data.mask)
    # a first step uploads the quadrature's nodes to the card, once per device
    tvgp.natural_gradient_step_with_status(params, *args, 0.5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stepped, ok = tvgp.natural_gradient_step_with_status(params, *args, 4.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not bool(ok)
    assert torch.equal(stepped.q_mu, params.q_mu) and torch.equal(stepped.q_sqrt, params.q_sqrt)
    taken, ok = tvgp.natural_gradient_step_with_status(params.replace(q_sqrt=torch.eye(data.capacity, device=device)), *args, 0.5)
    assert bool(ok) and bool(torch.isfinite(taken.q_sqrt).all())


def _ar1_on(device, dtype, N=4096):
    """A three-level AR(1) model on 50, 20 and 10 points, noise/signal 1e-3 (the fused
    gate admits it), and an [N, 2] pool with every fidelity."""
    from trieste_tpu_torch import convert

    g = torch.Generator().manual_seed(1)
    levels = []
    for n, var, ls in ((50, 1.3, 0.2), (20, 0.4, 0.3), (10, 0.2, 0.5)):
        x = torch.rand(n, 1, generator=g, dtype=torch.float64)
        levels.append((dict(kind="matern52", variance=var, lengthscales=[ls], noise_variance=1e-3 * var,
                            mean_constant=0.1), dict(query_points=x, observations=torch.sin(9 * x),
                                                     num_points=n, capacity=None)))
    model = convert.multifidelity_autoregressive_from_numpy([0.8, 0.9], levels, device=device, dtype=dtype)
    pool = torch.cat([torch.rand(N, 1, generator=g, dtype=torch.float64),
                      torch.randint(0, 3, (N, 1), generator=g).double()], -1)
    return model, pool.to(device, dtype)


def test_ar1_pool_launches_one_kernel_per_level_and_matches_the_plain_version(device):
    model, pool = _ar1_on(device, torch.float32)
    before = fp.launches
    mean, var = model.predict(pool)
    assert fp.launches == before + 3
    x = pool[:, :1].contiguous()
    for level in model._models:  # each level's kernel against its plain version, same operands
        got = level.predict(x)
        args = fp.operands(level.params, level.posterior_cache, x)
        want = fp.fused_predict_reference(args[0], *(t.double() for t in args[1:]))
        torch.testing.assert_close(got[0].double(), want[0], **MEAN_TOL)
        torch.testing.assert_close(got[1][:, 0].double(), want[1], **VAR_TOL)
    assert fp.launches == before + 6
    assert mean.shape == var.shape == (pool.shape[0], 1) and bool(torch.isfinite(mean).all())


def test_nargp_propagation_is_one_launch_per_level(device):
    """At 4096 rows and 8 samples, level 0 predicts 4096 rows and level 1 its 32,768
    propagated rows, each in one launch."""
    from trieste_tpu_torch import convert

    g = torch.Generator().manual_seed(2)
    x0 = torch.rand(40, 1, generator=g, dtype=torch.float64)
    x1 = torch.cat([x0[:15], torch.sin(9 * x0[:15])], -1)
    levels = [(dict(kind="matern52", variance=1.0, lengthscales=ls, noise_variance=1e-3, mean_constant=0.0),
               dict(query_points=x, observations=torch.cos(5 * x[:, :1]), num_points=x.shape[0], capacity=None))
              for x, ls in ((x0, [0.2]), (x1, [0.3, 1.0]))]
    model = convert.multifidelity_nonlinear_autoregressive_from_numpy(
        levels, 8, generator=torch.Generator(device=device).manual_seed(0), device=device,
        dtype=torch.float32)
    pool = torch.cat([torch.rand(4096, 1, device=device), torch.ones(4096, 1, device=device)], -1)
    before = fp.launches
    mean, var = model.predict(pool)
    assert fp.launches == before + 2
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())


def _mcmc_on(device, n=20, capacity=32):
    """A fully-Bayesian GP on ``n`` ScaledBranin-like points in fp32 on the card, and its
    log posterior's template."""
    from trieste_tpu_torch.data import Dataset
    from trieste_tpu_torch.models.gp import build_gpr_mcmc
    from trieste_tpu_torch.space import Box

    g = torch.Generator(device=device).manual_seed(4)
    X = torch.rand(n, 2, generator=g, device=device)
    data = Dataset.from_arrays(X, torch.sin(5 * X[:, :1]) + X[:, 1:] ** 2, capacity=capacity)
    model = build_gpr_mcmc(data, Box([0.0, 0.0], [1.0, 1.0], device=device), likelihood_variance=1e-6,
                           num_chains=3, num_samples_per_chain=5, num_warmup=5, num_retained=6,
                           optimize_generator=torch.Generator(device=device).manual_seed(0))
    return model, data


def _chains_on(device):
    """A function running 3 chains of 10 transitions (5 of warmup) over the GP log
    posterior, their momenta and uniforms drawn once."""
    from trieste_tpu_torch.models.gp import mcmc
    from trieste_tpu_torch.models.gp.training import pack_params

    model, data = _mcmc_on(device)
    u0 = pack_params(model._template)
    jitter, momenta, uniforms = mcmc._draw_chains(torch.Generator(device=device).manual_seed(1), 3, 10, u0)
    return lambda: mcmc._run_chains_from_draws(model._template, data.query_points, data.observations,
                                               data.mask, u0, jitter, momenta, uniforms, 5)


def test_hmc_transitions_read_nothing_back_from_the_card(device, monkeypatch):
    """Everything but the one capture of the transition's CUDA graph runs with a
    synchronizing call raising: the first evaluation, every replay and the step-size
    adaptation."""
    from trieste_tpu_torch.ops import hmc

    capture = hmc._transition_runner

    def capture_unchecked(*args):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return capture(*args)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(hmc, "_transition_runner", capture_unchecked)
    run = _chains_on(device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        result = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert result.samples.shape[:2] == (3, 5) and bool(torch.isfinite(result.samples).all())
    assert bool((result.accept_rate >= 0).all()) and bool(torch.isfinite(result.step_size).all())


def test_the_graphed_transitions_are_the_eager_ones(device, monkeypatch):
    from functools import partial

    from trieste_tpu_torch.ops import hmc

    run = _chains_on(device)
    graphed = run()
    monkeypatch.setattr(hmc, "_transition_runner",
                        lambda log_prob, num_leapfrog, state: partial(hmc._transition, log_prob, num_leapfrog, state))
    eager = run()
    for got, want in zip(graphed, eager):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_a_flush_of_mixed_deferred_summaries_makes_one_transfer(device):
    import warnings

    from trieste_tpu_torch import logging

    class Recorder:
        def __init__(self):
            self.events = []

        def add_scalar(self, name, value, step):
            self.events.append((name, value))

        def add_histogram(self, name, values, step):
            self.events.append((name, values.shape))

    x = torch.arange(12.0, device=device).reshape(3, 4)
    rec = Recorder()
    with logging.tensorboard_writer(rec):
        logging.deferred_scalar("s", x.sum())
        logging.deferred_scalar("closure", lambda: x.max())
        logging.deferred_scalar_vector(["a", "b", "c"], x[:, 0])
        logging.deferred_histogram("h", x)
        logging.deferred_histogram("h64", x.double())
        logging.deferred_scalar("host", 2.0)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                logging.flush_deferred_summaries()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    assert sum("called a synchronizing CUDA operation" in str(w.message) for w in caught) == 1
    assert dict(rec.events) == {"s": 66.0, "closure": 11.0, "a": 0.0, "b": 4.0, "c": 8.0,
                                "h": (3, 4), "h64": (3, 4), "host": 2.0}


def test_gpr_mcmc_prediction_on_a_pool_launches_no_kernel(device):
    """The mixture at 4096 rows (over the fused gate's size) goes by the exact path, held to
    the fp64 mixture of the same samples and factors."""
    from trieste_tpu_torch.models.gp import mcmc

    model, data = _mcmc_on(device)
    model.optimize(data)
    pool = torch.rand(4096, 2, generator=torch.Generator(device=device).manual_seed(5), device=device)
    before = fp.launches
    mean, var = model.predict(pool)
    assert fp.launches == before
    stack = model.params_stack
    stack64 = stack.replace(
        kernel=stack.kernel.replace(variance=stack.kernel.variance.double(),
                                    lengthscales=stack.kernel.lengthscales.double()),
        noise_variance=stack.noise_variance.double(), mean_constant=stack.mean_constant.double())
    caches = model.posterior_caches
    caches64 = caches.replace(X=caches.X.double(), L=caches.L.double(), alpha=caches.alpha.double())
    want_mean, want_var = mcmc._mixture_predict(stack64, caches64, pool.double())
    torch.testing.assert_close(mean.double(), want_mean, **MEAN_TOL)
    torch.testing.assert_close(var.double(), want_var, **VAR_TOL)


# -- the deep models: the fits' CUDA graphs, fp32 against fp64, the propagation's memory -----


def _deep_data(device, dtype, n=30, D=2, capacity=32):
    from trieste_tpu_torch.data import Dataset

    g = torch.Generator(device=device).manual_seed(0)
    X = torch.rand(n, D, generator=g, dtype=torch.float64, device=device)
    Y = torch.sin(5 * X[:, :1]) + X[:, 1:].sum(-1, keepdim=True)
    return Dataset.from_arrays(X.to(dtype), Y.to(dtype), capacity=capacity)


def _ensemble_fit(device, dtype, steps=100):
    """Three members (hidden 25, 25) fitted ``steps`` steps in ``dtype`` from the same fp64
    start and bootstrap."""
    from trieste_tpu_torch.models.ensembles import deep_ensemble as de

    start = de.build_deep_ensemble(_deep_data(device, torch.float64), ensemble_size=3,
                                   generator=torch.Generator(device=device).manual_seed(1)).params
    net = start.member_params
    params = start.replace(
        member_params=de.GaussianMLP([k.to(dtype) for k in net.kernels], [b.to(dtype) for b in net.biases]),
        x_mean=start.x_mean.to(dtype), x_std=start.x_std.to(dtype), y_mean=start.y_mean.to(dtype),
        y_std=start.y_std.to(dtype))
    data = _deep_data(device, dtype)
    indices = de.bootstrap_indices(torch.Generator(device=device).manual_seed(2), data.mask, 3)
    return de.fit_deep_ensemble_from_indices(indices, params, data.query_points, data.observations,
                                             data.mask, num_steps=steps)


def _dgp_start(device, dtype):
    """A two-layer deep GP (16 inducing points) built in fp64 and cast to ``dtype``."""
    from trieste_tpu_torch.models.deepgp import deep_gp as dg
    from trieste_tpu_torch.space import Box

    start = dg.build_vanilla_deep_gp(_deep_data(device, torch.float64),
                                     Box([0.0, 0.0], [1.0, 1.0], device=device, dtype=torch.float64),
                                     num_inducing_points=16,
                                     generator=torch.Generator(device=device).manual_seed(1)).params
    cast = lambda t: t.to(dtype)  # noqa: E731
    return start.replace(
        layers=tuple(l.replace(kernel=l.kernel.replace(variance=cast(l.kernel.variance),
                                                       lengthscales=cast(l.kernel.lengthscales)),
                               inducing_points=cast(l.inducing_points), q_mu=cast(l.q_mu),
                               q_sqrt=cast(l.q_sqrt)) for l in start.layers),
        noise_variance=cast(start.noise_variance), mean_constant=cast(start.mean_constant))


def _dgp_fit(device, dtype, steps=100):
    """:func:`_dgp_start` fitted ``steps`` steps in ``dtype`` on the same fp64 noise; returns
    the result and an fp64 noise for predictions."""
    from trieste_tpu_torch.models.deepgp import deep_gp as dg

    params, data64 = _dgp_start(device, dtype), _deep_data(device, torch.float64)
    g = torch.Generator(device=device).manual_seed(3)
    noise = dg.draw_noise(g, params, (steps, 8), data64.capacity, data64.query_points)
    data = _deep_data(device, dtype)
    result = dg.fit_dgp_from_noise(noise.to(dtype), params, data.query_points, data.observations,
                                   data.mask)
    return result, dg.draw_noise(g, params, (16,), 64, data64.query_points)


DGP_GRADIENT_ATOL = 3e-5
"""The deep GP's fp32 gradient at the start against fp64's, as a share of fp64's largest
element (the noise variance's): measured 9.4e-6 on the H100, at the outer layer's
``q_sqrt`` and ``q_mu`` (their terms are residuals over a small noise variance, which
cancel). On the CPU a jitter of 1e-4 in place of fp32's 1e-5 moves it to 8.5e-5."""


def _dgp_gradient(device, dtype):
    """The gradient of the negative ELBO of :func:`_dgp_start` on one fp64 draw of 8 paths
    with respect to every parameter that the fit trains."""
    from trieste_tpu_torch.models.deepgp import deep_gp as dg

    params, data = _dgp_start(device, dtype), _deep_data(device, dtype)
    noise = dg.draw_noise(torch.Generator(device=device).manual_seed(3), params, (8,),
                          data.capacity, data.query_points.double())
    leaves = [t.clone().requires_grad_(True) for l in params.layers
              for t in (l.kernel.variance, l.kernel.lengthscales, l.inducing_points, l.q_mu, l.q_sqrt)]
    leaves += [params.noise_variance.clone().requires_grad_(True),
               params.mean_constant.clone().requires_grad_(True)]
    layers = tuple(l.replace(kernel=l.kernel.replace(variance=leaves[5 * i],
                                                     lengthscales=leaves[5 * i + 1]),
                             inducing_points=leaves[5 * i + 2], q_mu=leaves[5 * i + 3],
                             q_sqrt=leaves[5 * i + 4]) for i, l in enumerate(params.layers))
    loss = -dg.dgp_elbo_from_noise(dg.DGPParams(layers, leaves[-2], leaves[-1]), data.query_points,
                                   data.observations, data.mask, noise.to(dtype))
    return torch.autograd.grad(loss, leaves)


def test_deep_fits_in_fp32_hold_to_fp64_on_the_card(device):
    """The same fits from the same start and draws in fp32 and fp64. Adam's first steps move
    a parameter by the learning rate whatever its gradient's size, so a gradient below fp32's
    rounding can step the other way, and the two paths part within tens of steps (the
    ensemble's final losses were -1.295 in fp32 and -1.146 in fp64 on the H100). The deep
    GP's part at the first step: at the builder's start its inner layer's gradients are
    rounding (about 1e-16 in fp64, 1e-6 in fp32), which Adam's first step turns into moves
    of the learning rate in fp32 alone. Held: the objective at the start within rtol 1e-5;
    the ensemble's predictions after 10 steps within atol 1e-4 (the targets span about 4);
    the deep GP's gradient at the start, every parameter's within DGP_GRADIENT_ATOL of the
    largest; after 100 steps, each fp32 fit's final loss no higher than the fp64 fit's by
    more than a tenth of the fp64 fit's descent."""
    from trieste_tpu_torch.models.ensembles import deep_ensemble as de

    x = torch.rand(64, 2, generator=torch.Generator(device=device).manual_seed(5),
                   dtype=torch.float64, device=device)
    fits = {"ensemble": lambda dtype, steps: _ensemble_fit(device, dtype, steps),
            "deep GP": lambda dtype, steps: _dgp_fit(device, dtype, steps)[0]}
    for name, fit in fits.items():
        start32, start64 = fit(torch.float32, 1).loss, fit(torch.float64, 1).loss
        torch.testing.assert_close(start32.double(), start64, rtol=1e-5, atol=0, msg=name)
        r32, r64 = fit(torch.float32, 100), fit(torch.float64, 100)
        assert int(r32.num_nonfinite) == int(r64.num_nonfinite) == 0, name
        descent = float(start64 - r64.loss)
        assert descent > 0 and float(r32.loss.double() - r64.loss) <= 0.1 * descent, (
            name, float(r32.loss), float(r64.loss), descent)
    r32, r64 = _ensemble_fit(device, torch.float32, 10), _ensemble_fit(device, torch.float64, 10)
    for got, want in zip(de.ensemble_predict(r32.params, x.float()), de.ensemble_predict(r64.params, x)):
        torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-4)
    grad32, grad64 = _dgp_gradient(device, torch.float32), _dgp_gradient(device, torch.float64)
    scale = max(float(g.abs().max()) for g in grad64)
    for i, (got, want) in enumerate(zip(grad32, grad64)):
        torch.testing.assert_close(got.double(), want, rtol=0, atol=DGP_GRADIENT_ATOL * scale,
                                   msg=f"leaf {i}")


def test_the_graphed_adam_steps_are_the_eager_ones(device, monkeypatch):
    """Both fits replay one CUDA graph of a step; eagerly, with the same capturable Adam,
    they end on the same bits."""
    from functools import partial

    from trieste_tpu_torch.ops import adam

    graphed = [_ensemble_fit(device, torch.float32, 30), _dgp_fit(device, torch.float32, 30)[0]]
    monkeypatch.setattr(adam, "_step_runner", lambda leaves, optimizer, loss_fn, nonfinite:
                        partial(adam._step, loss_fn, optimizer, nonfinite))
    eager = [_ensemble_fit(device, torch.float32, 30), _dgp_fit(device, torch.float32, 30)[0]]
    for g, e in zip(graphed, eager):
        assert torch.equal(g.loss, e.loss)
    for g, e in zip(graphed[0].params.member_params.parameters(),
                    eager[0].params.member_params.parameters()):
        assert torch.equal(g, e)
    for g, e in zip(graphed[1].params.layers, eager[1].params.layers):
        for name in ("inducing_points", "q_mu", "q_sqrt"):
            assert torch.equal(getattr(g, name), getattr(e, name))
        assert torch.equal(g.kernel.lengthscales, e.kernel.lengthscales)


def test_the_graphed_dgp_fit_reads_each_block_of_noise(device, monkeypatch):
    """Under a cap of seven steps' noise, a graphed fit of 20 steps draws four blocks and
    ends on the bits of the fit on those blocks end to end."""
    from trieste_tpu_torch.models.deepgp import deep_gp as dg

    (start, _), data = _dgp_fit(device, torch.float32, 1), _deep_data(device, torch.float32)
    params = start.params
    monkeypatch.setattr(dg, "FIT_NOISE_BLOCK_BYTES", 7 * 8 * data.capacity * params.noise_width * 4)
    drawn = []
    draw = dg.draw_noise
    monkeypatch.setattr(dg, "draw_noise", lambda *a: drawn.append(draw(*a)) or drawn[-1])
    got = dg.fit_dgp(torch.Generator(device=device).manual_seed(4), params, data.query_points,
                     data.observations, data.mask, num_steps=20)
    assert [b.shape[0] for b in drawn] == [7, 7, 6]
    want = dg.fit_dgp_from_noise(torch.cat(drawn), params, data.query_points,
                                 data.observations, data.mask)
    assert torch.equal(got.loss, want.loss)
    for a, b in zip(got.params.layers, want.params.layers):
        assert torch.equal(a.q_sqrt, b.q_sqrt) and torch.equal(a.inducing_points, b.inducing_points)


def test_deep_models_fit_and_predict_on_the_card(device):
    from trieste_tpu_torch.models.deepgp import build_vanilla_deep_gp
    from trieste_tpu_torch.models.ensembles import build_deep_ensemble
    from trieste_tpu_torch.space import Box

    data = _deep_data(device, torch.float32)
    space = Box([0.0, 0.0], [1.0, 1.0], device=device)
    for model in (build_deep_ensemble(data, num_train_steps=20),
                  build_vanilla_deep_gp(data, space, num_train_steps=20)):
        result = model.optimize(data)
        assert result.loss.is_cuda and bool(torch.isfinite(result.loss))
        mean, var = model.predict(space.sample(torch.Generator(device=device).manual_seed(0), 10))
        assert mean.is_cuda and var.is_cuda and mean.shape == (10, 1)
        traj = model.trajectory_sampler().get_trajectory(torch.Generator(device=device).manual_seed(1), 4)
        assert traj(torch.rand(7, 4, 2, device=device)).is_cuda


def test_dgp_predict_at_131072_rows_stays_under_its_reckoning(device):
    """Phase 30's prediction: 64 paths of a two-layer deep GP at full width (M = 100, width
    6) through chunks of samples. The peak above the model is held to the noise, one
    chunk's budget and the paths."""
    from trieste_tpu_torch.data import Dataset
    from trieste_tpu_torch.models.deepgp import build_vanilla_deep_gp, deep_gp as dg
    from trieste_tpu_torch.space import Box

    g = torch.Generator(device=device).manual_seed(0)
    X = torch.rand(200, 6, generator=g, device=device)
    data = Dataset.from_arrays(X, X.sum(-1, keepdim=True), capacity=256)
    model = build_vanilla_deep_gp(data, Box([0.0] * 6, [1.0] * 6, device=device))
    N, S = 131072, 64
    pool = torch.rand(N, 6, generator=g, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        mean, var = model.predict(pool)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    reckoned = S * N * model.params.noise_width * 4 + dg.PROPAGATE_CHUNK_BYTES + 2 * S * N * 4
    assert peak <= reckoned, (peak, reckoned)
    assert mean.shape == var.shape == (N, 1) and bool(torch.isfinite(mean).all())
    assert bool((var > 0).all())


def test_a_one_rank_mesh_takes_the_unsharded_path_on_the_card(device, monkeypatch):
    """An EI acquire over a 5000-row pool under a mesh of one rank: the same point bit for
    bit, the same kernel launches, and no collective call."""
    import torch.distributed as dist

    from trieste_tpu_torch.acquisition import EfficientGlobalOptimization
    from trieste_tpu_torch.acquisition.optimizer import generate_continuous_optimizer
    from trieste_tpu_torch.data import Dataset
    from trieste_tpu_torch.models.gp import build_gpr
    from trieste_tpu_torch.objectives import ScaledBranin
    from trieste_tpu_torch.parallel import create_mesh, global_mesh

    calls = []
    for name in ("all_gather", "all_reduce", "broadcast", "all_gather_into_tensor", "barrier"):
        if hasattr(dist, name):
            monkeypatch.setattr(dist, name, lambda *a, _n=name, **k: calls.append(_n))
    space = ScaledBranin.search_space
    g = torch.Generator(device=device).manual_seed(0)
    X = space.sample(g, 20)
    data = Dataset.from_arrays(X, ScaledBranin.objective(X))
    model = build_gpr(data, space)
    model.optimize(data)
    rule = EfficientGlobalOptimization(optimizer=generate_continuous_optimizer(5000))

    def acquire():
        fp.launches = 0
        point = rule.acquire_single(space, model, data,
                                    generator=torch.Generator(device=device).manual_seed(1))
        torch.cuda.synchronize()
        return point, fp.launches

    base, base_launches = acquire()
    mesh = create_mesh()
    with global_mesh(mesh):
        point, launches = acquire()
    assert mesh.size == 1 and mesh.group is None
    assert base_launches == launches == 1
    assert torch.equal(point, base)
    assert calls == []
