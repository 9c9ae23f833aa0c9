#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``trieste_tpu_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``. It needs
one CUDA device, ``nvcc`` (under ``$CUDA_HOME``, default ``/usr/local/cuda``) and no
network, and it builds the CUDA kernel from the checkout's sources on first use.

Phases, each printing its own lines and its seconds:

1. device: the card's name and power limit, TF32 off, the kernel build;
2. kernel against its plain version: every kernel kind, ``P`` in {1, 2, 8}, training
   capacities ``C`` in {100, 128, 1000, 1024} with part of each capacity masked, and a pool
   size that is not a multiple of the kernel's block; then the quickstart's shapes
   (D = 2, C in {8, 16, 32}, N = 5000); then the edges of the kernel's tiles and blocks
   (C in {8, 9, 31, 127, 129, 255, 256, 257, 513}, N in {1, 63, 64, 65, 127, 129},
   D in {1, 3, 5, 7, 8, 9, 12, 20, 129, 300}) and one-hot operands (alpha = e_k, LinvT a
   single non-zero row k, at D = 6 and at D = 129 and 300) that pin the tensor-core
   fragment layout; the kernel in fp32 against
   ``fused_predict_reference`` in fp64 on the same inputs, within the TPU kernel's
   contract. A reported case over white-noise targets (rbf, C = 1024) prints the plain
   fp32 version's error beside the kernel's and is held to a small multiple of it;
3. the production shape (N = 131072, C = 1024, D = 6, matern52, P = 1): the kernel (with
   its prologue, as the path launches it), the prologue alone, the plain version and the
   unfused torch prediction (Gram, matmul, triangular solve), timed with CUDA events,
   beside the card's bound for the work the function needs: three TF32 tensor-core
   products per needed product (and, beside it, what three bf16 products each would
   allow); and the kernel at the quickstart's shape and at the production shape with
   D = 12, where the candidate rows live in shared memory and no longer in registers,
   and with D = 128, where they and the training rows are read from global memory;
4. the main path, convergence: the README quickstart on ScaledBranin with the
   default-noise ``build_gpr`` for up to 20 steps, held to rtol 0.005 of the minimum;
5. the main path at full width: Hartmann6 with 1000 initial points (capacity 1024) and a
   131072-point seed pool, 2 steps;
6. Ask/Tell with a batch rule at full width: the Hartmann6 data of phase 5 (1000 initial
   points, capacity 1024), ``BatchMonteCarloExpectedImprovement(1000)`` over 4 query
   points with the default optimizer (a 24-D joint space: 24,000 seeds, 240 runs); two
   rounds of ask, observe, tell; then ``to_state`` and ``from_state`` and a third ask from
   the restored optimizer, which must hold the same data and must not have refitted;
7. Monte-Carlo EI through the kernel: one ask with ``MonteCarloExpectedImprovement(2000)``
   on that model must launch the kernel, and the MC-EI scores of a seed pool through the
   kernel path are held against the same scores from the exact fp64 prediction with the
   same base draws, within the kernel's contract pushed through EI;
8. Thompson sampling, convergence: ScaledBranin from 5 initial points through
   ``BayesianOptimizer.optimize`` with ``DiscreteThompsonSampling(1000, 5)`` within 25
   steps and with parallel continuous Thompson sampling (4 query points) within 20, both
   to rtol 0.005 of the minimum. A seed-0 run that misses its budget is printed, seeds 1
   to 4 are run too, and the phase fails unless at least four of the five pass;
9. the asynchronous rule: ScaledBranin through Ask/Tell with
   ``AsynchronousOptimization(BatchMonteCarloExpectedImprovement(1000), num_query_points=2)``,
   one point of every batch told a round late so that the state holds pending points,
   within 20 rounds to rtol 0.005 (seeds as in phase 8);
10. Thompson sampling at full width: on the Hartmann6 model,
   ``DiscreteThompsonSampling(N, 10, ThompsonSamplerFromTrajectory())`` with N the largest
   power of two whose reckoned feature bytes stay under a quarter of the card's memory,
   one acquire; and trajectories at a likelihood variance of 1e-7 in fp32 must be finite;
11. the other acquisition families, convergence: ScaledBranin from 5 initial points with
   the default-noise ``build_gpr``, each rule within the reference's budget to rtol 0.005
   (``tests/integration/test_bayesian_optimization.py:147-148``): the negative LCB (25
   steps), MES (25), GIBBON with 2 query points (20), local penalization with 3 (25), the
   Fantasizer with 3 (20) and MONLCB with 3 (30); seeds as in phase 8. Every rule scores
   its first point's seed pool through the kernel and must launch it;
12. greedy and entropy batches at full width: one acquire each of local penalization (3
   points), the Fantasizer (3), GIBBON (2), MES and MONLCB (3) on phase 5's Hartmann6 model
   with its 131072-seed optimizer; distinct points, the kernel held against its fp64 plain
   version on that model, and the Fantasizer's peak memory under 8 GB (its conditioned
   marginal never forms the [131072, 131072] block);
13. active learning as the JAX package's tests set it up
   (``tests/integration/test_active_learning.py:26-104``): predictive variance on
   ScaledBranin for 30 steps, max error under 5% of the range at 4096 test points;
   expected feasibility at 80 on Branin for 15 steps, level-set accuracy above 0.9 (seeds
   as in phase 8); one acquire of integrated variance reduction over 1000 Sobol points;
14. trust regions to convergence, as the JAX package's integration tests set them up
   (``tests/integration/test_bayesian_optimization.py:91-99,147-149``): ScaledBranin from
   5 initial points, ``build_gpr`` with a likelihood variance of 1e-4 (the reference's
   1e-7 is gated off the kernel; see ``TRUST_REGION_NOISE``) and ``stop_at_minimum`` at
   rtol 0.005; TREGO (one ``TREGOBox`` and EI) within 25 steps, TuRBO (one ``TURBOBox``, a
   one-rule list) within 30, ``BatchTrustRegionBox(init_subspaces=3)`` with its default
   MONLCB within 15 (seeds as in phase 8); each must launch the kernel, and the kernel is
   held against its fp64 plain version on the batch fleet's final seed pool (its three
   regions' rows from three boxes). Then the mixed-space ``BatchTrustRegionProduct``
   (``tests/integration/test_mixed_space_bayesian_optimization.py:65-123``): 10 regions of
   a fixed grid point by a box, parallel continuous Thompson sampling over 10 points,
   ``likelihood_variance=1e-7``, 8 steps, rtol 0.005 (seed 1, seeds 2 to 5 if it misses);
   and TREGO through Ask/Tell for 20 rounds with a ``to_state``/``from_state`` restart at
   round 10, rtol 0.005 (``tests/integration/test_ask_tell_optimization.py:24-82``);
15. a trust-region fleet at full width: phase 5's Hartmann6 model (capacity 1024),
   ``BatchTrustRegionBox(init_subspaces=10)`` with MONLCB over 10 points on a 131072-seed,
   60-run optimizer: one ``filter_datasets`` and one acquire. Ten distinct points, each in
   its own region; every local dataset at capacity 1024 with as many points as its region
   holds; one kernel launch over the 1,310,720 seed rows, held against its fp64 plain
   version on those rows;
16. multi-objective BO to the reference's envelopes
   (``tests/integration/test_multi_objective_bayesian_optimization.py:31-110``): VLMOP2
   from the JAX test's 10-point initial design (``VLMOP2_DESIGNS``), a
   ``TrainableModelStack`` of two ``build_gpr`` members at a
   likelihood variance of 1e-5; the log hypervolume difference to the ideal front below
   -3.65 after 20 steps of EHVI (default optimizer, 5000 seeds), below -3.44 after 15 of
   qEHVI over 2 points and below -3.2095 after 10 of HIPPO over 4 (500 seeds each); and
   qHSRI over 3 points (population 50, 15 generations) on SimpleQuadratic within rtol 0.05
   in 6 steps (``tests/integration/test_bayesian_optimization.py:100-102,136-140``); seeds
   (the JAX test's designs 0 to 4) as in phase 8. EHVI must launch the kernel, and the kernel is held against its fp64
   plain version on each member's first seed pool;
17. a multi-objective stack at full width: DTLZ2(6, 2) with 1000 initial points, a
   two-member stack at capacity 1024 fitted once, and one acquire each of EHVI and HIPPO
   over 4 points on phase 5's optimizer (131072 seeds, 60 runs) and of qEHVI over 2
   points (500 seeds); EHVI launches the kernel once per member, and the kernel is held
   against its fp64 plain version on each member's pool;
18. constrained BO to convergence: Gardner's problem with ECI (EI times the probability of
   feasibility under a second ``build_gpr`` model) from the JAX test's 6-point design
   (``GARDNER_DESIGN``) within 12 steps, minimizer within 0.05 and minimum -2 within rtol
   0.005 (``tests/integration/test_constrained_bayesian_optimization.py:86-110``); then
   ``ConstrainedScaledBranin`` from 5 feasible points with EI over the constrained box and
   with ECI of the box's own ``FastConstraintsFeasibility``, each within 20 steps to rtol
   0.005 of the feasible minimum of a 2001 x 2001 grid (-1.04741; the problem declares
   -0.99888, a fault of the reference) with every query point feasible; seeds as in
   phase 8; each rule's 5000-row feasible pools go through the kernel;
19. a constrained acquire at full width: phase 5's Hartmann6 model (capacity 1024) over the
   box with ``sum(x) <= 2``: one EI acquire at 131,072 feasible seeds (about 8% of each
   draw is feasible) and 60 runs; the point feasible, one kernel launch over the pool, the
   kernel held against its fp64 plain version on it;
20. the sparse models to convergence as the JAX package's integration test sets them up
   (``tests/integration/test_model_bayesian_optimization.py:23-115``): ScaledBranin from 6
   points, SGPR (50 inducing points, the conditional-improvement selector, likelihood
   1e-7) within 14 steps to rtol 0.005 and SVGP (20 inducing points, likelihood 1e-6 not
   trained) within 40 to rtol 0.05; seeds as in phase 8; no kernel launch (the kernel
   serves the exact GP only);
21. the sparse models at full width: Hartmann6 with 20,000 observations; ``build_sgpr``
   with 500 inducing points and the conditional-variance selector (one update over the
   dense [20000, 20000] Gram), one fit and one EI acquire at 131,072 seeds; ``build_svgp``
   with 500 inducing points, one fit of 500 Adam steps on minibatches of 1000 and one
   acquire; 10 decoupled inducing trajectories of the SGPR model at 131,072 candidates.
   Both models' means at 1000 held-out points must reach an RMSE under half of std(y);
22. one JSON line describing each kernel. Its ``max_abs_err`` covers every case held to
   the contract, including the kernel on the fitted models that phases 4 to 7, 12, 14 to
   17 and 19 leave behind; the white-noise case has keys of its own.

Phases 6 to 21 each print their seconds, the bytes reckoned for their largest tensors and
``torch.cuda.max_memory_allocated()``; phases 11 to 21 print their kernel launches.

The last line is ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before it; so does a machine without a CUDA device, or a directory without the package.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

MEAN_RTOL, MEAN_ATOL = 1e-3, 3e-4  # the TPU kernel's contract (tests/unit/test_fused_predict.py)
VAR_RTOL, VAR_ATOL = 5e-3, 3e-4
WHITE_NOISE_FACTOR = 4.0  # the white-noise case's limit, in units of the plain fp32 error
FP32_PEAK = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores, NVIDIA data sheet, 700 W
TF32_PEAK = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s, same source
BF16_PEAK = 990e12  # H100 SXM dense bf16 tensor-core FLOP/s, same source
TF32_PASSES = 3  # tensor-core products per product of fp32-grade precision (hi/lo splits)
HBM_RATE = 3.35e12  # H100 SXM device-memory bytes/s, same source
QUICKSTART_SEED = 0
QUICKSTART_STEPS = 20
SCALED_BRANIN_RTOL = 0.005
# The box-region rules' likelihood variance: the reference's 1e-7 is below the fused gate's
# noise/signal ratio (1e-5), and the default y_var/100 smooths ScaledBranin so much that TREGO
# stalls (two of five seeds at rel err 2.9e-2 and 1.1e-1 after 25 steps, CPU rehearsal)
TRUST_REGION_NOISE = 1e-4
# The multi-objective stacks' likelihood variance, the reference's
# (tests/integration/test_multi_objective_bayesian_optimization.py:36)
MULTI_OBJECTIVE_NOISE = 1e-5
QHSRI_RTOL = 0.05  # tests/integration/test_bayesian_optimization.py:136-140
# The initial designs of the JAX package's VLMOP2 test for seeds 0 to 4, 10 points in
# [-2, 2]^2 each (``_run_vlmop2``: ``Box.sample(jax.random.split(PRNGKey(seed))[0], 10)``
# in float32), as numbers: the smoke imports no JAX. A run's log hypervolume difference is
# a function of its initial design (the seed pools and fit restarts barely move it), and
# the reference's envelopes were set on one such design, so phase 16 starts from these;
# tests/test_torch_multi_objective.py checks them against the JAX package.
VLMOP2_DESIGNS = (
    (1.3692564964294434, -1.2704854011535645, -1.091287612915039, -1.5170974731445312,
     -1.2327461242675781, 0.8880600929260254, 1.0617823600769043, -1.3898382186889648,
     1.8068251609802246, -1.8827581405639648, -1.6051578521728516, 0.21257305145263672,
     -1.502211570739746, 0.3782482147216797, 1.8379631042480469, 0.7729086875915527,
     0.8963837623596191, -0.7273426055908203, 1.2802858352661133, 0.5641050338745117),
    (0.8104610443115234, -1.0606613159179688, 1.2714581489562988, -1.3162355422973633,
     -1.894608974456787, 1.6904377937316895, 0.7778935432434082, -0.43355751037597656,
     0.8132576942443848, -0.495572566986084, 1.366013526916504, -0.9114565849304199,
     -1.171854019165039, 0.041259765625, -1.8504228591918945, 1.2032980918884277,
     -0.781919002532959, -1.4285759925842285, -0.02313709259033203, 1.364560604095459),
    (0.5451722145080566, 0.5713286399841309, -1.6282048225402832, 1.0003752708435059,
     0.36612558364868164, -0.717522144317627, 1.148510456085205, 0.10046005249023438,
     1.577423095703125, 0.15921545028686523, 1.3232612609863281, 1.9498767852783203,
     0.8826837539672852, -0.4328298568725586, -0.8773860931396484, 1.7663788795471191,
     -0.666285514831543, -0.3587007522583008, -0.5342960357666016, 1.4116387367248535),
    (-1.9652185440063477, -1.8240461349487305, -0.7537078857421875, -1.3290314674377441,
     0.3017139434814453, 1.4693565368652344, 1.0966095924377441, -1.932948112487793,
     1.9707446098327637, -1.4816293716430664, -1.9908084869384766, 0.6316494941711426,
     -0.1273331642150879, 0.2266697883605957, -0.04206371307373047, 0.8642339706420898,
     0.9789900779724121, 0.9609246253967285, -1.2050437927246094, 0.709561824798584),
    (0.1873340606689453, 1.2506747245788574, 1.0214686393737793, -0.15569686889648438,
     0.31362056732177734, -0.7756624221801758, -1.478074550628662, 1.052077293395996,
     -0.6251931190490723, 1.7026515007019043, -0.1335611343383789, 1.6528840065002441,
     0.7707719802856445, 0.9017624855041504, 1.3112974166870117, -1.4587950706481934,
     0.8654417991638184, -1.9544463157653809, -1.9981107711791992, -0.03472185134887695),
)
# The initial design of the JAX package's Gardner ECI test
# (tests/integration/test_constrained_bayesian_optimization.py, ``_run``:
# ``Box([0, 0], [6, 6]).sample(jax.random.split(PRNGKey(3))[0], 6)``, float64), as numbers.
# Gardner's problem has a second feasible near-optimum at b = 6, and that test's seed was
# chosen for a design that covers the b = 0 basin, so phase 18 starts from it;
# tests/test_torch_constraints.py checks it against the JAX package.
GARDNER_DESIGN = (
    1.022659904550578, 2.0116367694495514, 2.9981125633066226, 1.6084408295772898,
    4.5528157595311916, 1.0986259099199898, 4.808495970037411, 5.509303474242305,
    3.46180949839025, 1.0699158730669742, 4.311917319032187, 0.6285433783636512,
)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL {msg}")


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def compare(kernel_out, plain_out):
    """(max abs err of mean, of var, max rel err of mean, of var, within the contract)."""
    (mk, vk), (mr, vr) = kernel_out, plain_out
    em, ev = (mk.double() - mr).abs(), (vk.double() - vr).abs()
    ok = bool((em <= MEAN_ATOL + MEAN_RTOL * mr.abs()).all()) and bool(
        (ev <= VAR_ATOL + VAR_RTOL * vr.abs()).all()
    )
    rm = (em / mr.abs().clamp_min(1e-30)).max().item()
    rv = (ev / vr.abs().clamp_min(1e-30)).max().item()
    return em.max().item(), ev.max().item(), rm, rv, ok


def synthetic_state(kind, C, P, seed, device, D=6, white_noise=False):
    """A partly masked fp64 posterior of capacity ``C`` in ``D`` dimensions, over smooth
    targets or, with ``white_noise``, over independent standard normal ones."""
    from trieste_tpu_torch.models.gp.posterior import GPRParams, build_cache
    from trieste_tpu_torch.ops.kernels import stationary

    g = torch.Generator(device=device).manual_seed(seed)
    f64 = torch.float64
    X = torch.rand(C, D, generator=g, dtype=f64, device=device)
    W = torch.randn(D, P, generator=g, dtype=f64, device=device)
    Y = torch.cos(X @ W) + X.sum(-1, keepdim=True)
    if white_noise:
        Y = torch.randn(C, P, generator=g, dtype=f64, device=device)
    mask = torch.arange(C, device=device) < C - C // 5
    params = GPRParams(
        kernel=stationary(kind, 1.7, [0.4 + 0.1 * d for d in range(D)], dtype=f64, device=device),
        noise_variance=torch.tensor(1e-3, dtype=f64, device=device),
        mean_constant=torch.tensor(0.25, dtype=f64, device=device),
    )
    cache = build_cache(params, X * mask[:, None], Y * mask[:, None], mask)
    return params, cache, g


def raw_kernel_and_plain(kind, xs, A, alpha, LinvT, scal):
    """The kernel and its fp64 plain version on fp32 operands given as they are."""
    from trieste_tpu_torch.ops import fused_predict as fp

    out = fp.launch(kind, xs, A, alpha, LinvT, scal)
    torch.cuda.synchronize()
    operands = (xs, A, alpha, LinvT, scal)
    return out, fp.fused_predict_reference(kind, *(t.double() for t in operands))


def kernel_and_plain(params, cache, flat):
    """The kernel in fp32 and its plain version in fp64 on the same fp32 operands:
    ``(kernel out, fp64 plain out, fp32 operands)``."""
    from trieste_tpu_torch.ops import fused_predict as fp

    ops = fp.operands(params, cache, flat)
    args = (ops[0],) + tuple(t.float().contiguous() for t in ops[1:])
    return (*raw_kernel_and_plain(*args), args)


def bounds(N, n, C, D, P):
    """The least time the card needs for one call, from the work this call's data needs.

    ``n`` of the ``C`` training slots are live and ``LinvT`` is upper triangular on them,
    so ``v = K·L⁻ᵀ`` needs ``n(n+1)/2`` multiply-adds per row; r², the mean and ``Σv²``
    need ``n·(D + P + 1)`` more. At fp32-grade precision the tensor cores take
    ``TF32_PASSES`` TF32 products per needed product, so the operations run at
    ``TF32_PEAK / TF32_PASSES`` at best; the fp32 FMA pipes alone would run them at
    ``FP32_PEAK``. Three bf16 products each (hi/mid/lo splits of 8 mantissa bits, as the
    TPU kernel takes them) would meet the same contract at ``BF16_PEAK / TF32_PASSES``: the
    port's kernel does not take that route, and its time is shown against that floor too.
    Returns ``(FLOP needed, bytes moved, bound ms, what bounds it, the bound ms on the fp32
    FMA pipes, the bound ms with three bf16 products)``.
    """
    needed = N * n * (n + 1) + 2.0 * N * n * (D + P + 1)
    nbytes = 4.0 * (N * D + C * D + C * P + C * C + 2 + N * P + N)
    ops_s, bytes_s = needed * TF32_PASSES / TF32_PEAK, nbytes / HBM_RATE
    bound_by = "operations" if ops_s >= bytes_s else "bytes"
    fp32_fma_ms = max(needed / FP32_PEAK, bytes_s) * 1e3
    bf16x3_ms = max(needed * TF32_PASSES / BF16_PEAK, bytes_s) * 1e3
    return needed, nbytes, max(ops_s, bytes_s) * 1e3, bound_by, fp32_fma_ms, bf16x3_ms


def fp64_state(params, dataset):
    """A fitted model's hyperparameters in fp64 and the posterior cache of ``dataset``
    factorized in fp64 under them."""
    from trieste_tpu_torch.models.gp.posterior import build_cache

    kernel = params.kernel.replace(variance=params.kernel.variance.double(),
                                   lengthscales=params.kernel.lengthscales.double())
    p64 = params.replace(kernel=kernel, noise_variance=params.noise_variance.double(),
                         mean_constant=params.mean_constant.double())
    cache = build_cache(p64, dataset.query_points.double(), dataset.observations.double(),
                        dataset.mask, with_linvt=False)
    return p64, cache


def check_on_path(label, model, space, n_pool, gen):
    """Hold the kernel against its plain version on a fitted model of the main path, at
    the seed pool's size; return the larger max abs error of mean and var."""
    from trieste_tpu_torch.ops import fused_predict as fp

    params, cache = model.params, model.posterior_cache
    pool = space.sample(gen, n_pool)
    if not fp.can_fuse(params, cache, pool):
        fail(f"{label}: the fitted model does not pass the fused gate")
    dead = ~cache.mask
    if (torch.count_nonzero(cache.LinvT.tril(-1)) or torch.count_nonzero(cache.LinvT[dead])
            or torch.count_nonzero(cache.LinvT[:, dead]) or torch.count_nonzero(cache.alpha[dead])):
        fail(f"{label}: the fitted model's LinvT is not upper triangular and zero on padding")
    out, plain, args = kernel_and_plain(params, cache, pool)
    em, ev, rm, rv, ok = compare(out, plain)
    C, D = args[2].shape
    print(f"{label} kernel vs plain (fp64) on the fitted model ({args[0]}, N={n_pool} C={C} "
          f"live {int(cache.mask.sum())} D={D}): mean abs {em:.3e} rel {rm:.3e}, var abs "
          f"{ev:.3e} rel {rv:.3e} {'ok' if ok else 'OUT OF TOLERANCE'}")
    if not ok:
        fail(f"{label}: kernel disagrees with its plain version on the fitted model")
    return max(em, ev)


def memory_line(label: str, reckoned_bytes: float, t_phase: float) -> None:
    """A phase's seconds, the bytes reckoned for it and the peak the allocator saw."""
    torch.cuda.synchronize()
    print(f"{label} seconds: {time.perf_counter() - t_phase:.2f}; reckoned peak "
          f"{reckoned_bytes / 1e9:.3f} GB, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")


def timed(fn):
    """``fn()`` and the seconds it took, the device's work included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def relative_error(best: float, minimum: float) -> float:
    return abs(best - minimum) / abs(minimum)


def bo_run(make_rule, problem, space, budget, seed, *, likelihood_variance=None, num_initial=5,
           halton=False, stop_rtol=SCALED_BRANIN_RTOL, early_stop=None):
    """``BayesianOptimizer.optimize`` on ``problem`` from ``num_initial`` points (uniform, or
    Halton), stopped early once the best observation is within ``stop_rtol`` of the
    minimum (``None``: never) or by ``early_stop`` where given: ``(result, evaluations after
    the initial points, seconds)``."""
    from trieste_tpu_torch import BayesianOptimizer
    from trieste_tpu_torch.models.gp import build_gpr
    from trieste_tpu_torch.objectives import mk_observer

    observer = mk_observer(problem.objective)
    gen = torch.Generator(device=space.device).manual_seed(seed)
    initial = observer(
        space.sample_halton(gen, num_initial) if halton else space.sample(gen, num_initial)
    )
    minimum = float(problem.minimum[0])

    def reached(datasets, _models, _state=None):
        best = float(datasets["OBJECTIVE"].trimmed_observations.min())
        return abs(best - minimum) <= stop_rtol * abs(minimum)

    if early_stop is None and stop_rtol is not None:
        early_stop = reached
    model = build_gpr(initial, space, likelihood_variance=likelihood_variance)
    t0 = time.perf_counter()
    result = BayesianOptimizer(observer, space).optimize(
        budget, initial, model, make_rule(), generator=gen, track_state=False,
        early_stop_callback=early_stop,
    )
    torch.cuda.synchronize()
    if not result.is_ok:
        fail(f"a BO run failed: {result.final_result.error!r}")
    return result, len(result.try_get_final_dataset()) - num_initial, time.perf_counter() - t0


def four_of_five(label, run_seed, first_seed=0):
    """The first seed, and the four after it only where it fails; fail unless four of the
    five pass. ``run_seed(seed) -> (passed, what the first seed returns)``; returns the first
    seed's."""
    passed, first = run_seed(first_seed)
    if not passed:
        more = sum(run_seed(seed)[0] for seed in range(first_seed + 1, first_seed + 5))
        if more < 4:
            fail(f"{label}: {more} of 5 seeds passed")
    return first


def pairwise_min_distance(points: torch.Tensor) -> float:
    if points.shape[0] < 2:
        return float("inf")
    d = torch.cdist(points.double(), points.double())
    return float((d + torch.eye(points.shape[0], dtype=d.dtype, device=d.device) * 1e9).min())


def converge_families(dev) -> dict:
    """Phase 11: each of the other acquisition families to the minimum of ScaledBranin
    within the reference's budget; returns seed 0's kernel launches by rule."""
    from trieste_tpu_torch.acquisition import (
        GIBBON,
        EfficientGlobalOptimization,
        Fantasizer,
        LocalPenalization,
        MinValueEntropySearch,
        MultipleOptimismNegativeLowerConfidenceBound,
        NegativeLowerConfidenceBound,
    )
    from trieste_tpu_torch.objectives import ScaledBranin
    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    space = ScaledBranin.search_space.to(dev)
    minimum = float(ScaledBranin.minimum[0])
    ego = EfficientGlobalOptimization
    families = (
        ("NegativeLowerConfidenceBound(1.96)",
         lambda: ego(NegativeLowerConfidenceBound(1.96)), 25, 1),
        ("MinValueEntropySearch", lambda: ego(MinValueEntropySearch(space)), 25, 1),
        ("GIBBON, 2 query points", lambda: ego(GIBBON(space), num_query_points=2), 20, 2),
        ("LocalPenalization, 3 query points",
         lambda: ego(LocalPenalization(space), num_query_points=3), 25, 3),
        ("Fantasizer, 3 query points", lambda: ego(Fantasizer(), num_query_points=3), 20, 3),
        ("MultipleOptimismNegativeLowerConfidenceBound, 3 query points",
         lambda: ego(MultipleOptimismNegativeLowerConfidenceBound(space), num_query_points=3),
         30, 3),
    )
    # the largest tensors: GIBBON's joint prediction over 5000 seeds and 2 points (the
    # cross-covariance, the solve and its copy at capacity 64)
    reckoned = 3 * 5000 * 2 * 64 * 4
    launches = {}
    for name, make_rule, budget, batch in families:

        def run_seed(seed):
            fp.launches = 0
            result, evaluations, seconds = bo_run(make_rule, ScaledBranin, space, budget, seed)
            best = float(result.try_get_final_dataset().trimmed_observations.min())
            rel = relative_error(best, minimum)
            steps = evaluations // batch
            ok = rel <= SCALED_BRANIN_RTOL
            print(f"phase 11 {name} on ScaledBranin, seed {seed}: {steps} steps of {budget}, best "
                  f"{best:.6f}, rel err {rel:.3e} (limit {SCALED_BRANIN_RTOL}), "
                  f"{seconds / max(steps, 1):.3f} s/step, kernel launches {fp.launches} "
                  f"{'ok' if ok else 'MISSED'}")
            return ok, fp.launches

        launches[name] = four_of_five(name, run_seed)
        if launches[name] == 0:  # the first point of every step scores its pool marginally
            fail(f"{name}: the rule never launched the fused kernel")
    memory_line("phase 11", reckoned, t_phase)
    return launches


def full_width_batches(model, dataset, space, dev, max_abs_err):
    """Phase 12: one acquire of each greedy and entropy rule at full width; returns the
    running max abs error of the kernel and the launches by rule."""
    from trieste_tpu_torch.acquisition import (
        GIBBON,
        EfficientGlobalOptimization,
        Fantasizer,
        LocalPenalization,
        MinValueEntropySearch,
        MultipleOptimismNegativeLowerConfidenceBound,
        generate_continuous_optimizer,
    )
    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    N, C, D = 131072, dataset.capacity, space.dimension
    optimizer = generate_continuous_optimizer(num_initial_samples=N)
    ego = EfficientGlobalOptimization
    # (name, rule, points, reckoned bytes of the largest tensors): the exact path's Gram
    # K(rows, X) keeps up to six [rows, C] fp32 arrays alive at once (the expansion
    # |a|² + |b|² − 2a·b, then the Matérn-5/2 terms), at N rows for the Fantasizer's
    # conditioned marginal and 2N for GIBBON's joint repulsion; the others score the pool
    # through the kernel, whose operands are [N·V, D]
    gram_arrays = 6
    rules = (
        ("LocalPenalization", lambda: ego(LocalPenalization(space), optimizer, 3), 3,
         3 * N * D * 4),
        ("Fantasizer", lambda: ego(Fantasizer(), optimizer, 3), 3, gram_arrays * N * C * 4),
        ("GIBBON", lambda: ego(GIBBON(space), optimizer, 2), 2, gram_arrays * 2 * N * C * 4),
        ("MinValueEntropySearch", lambda: ego(MinValueEntropySearch(space), optimizer), 1,
         3 * N * D * 4),
        ("MultipleOptimismNegativeLowerConfidenceBound",
         lambda: ego(MultipleOptimismNegativeLowerConfidenceBound(space), optimizer, 3), 3,
         3 * 3 * N * D * 4),
    )
    gen = torch.Generator(device=dev).manual_seed(12)
    launches = {}
    for name, make_rule, B, reckoned in rules:
        torch.cuda.reset_peak_memory_stats()
        fp.launches = 0
        points, seconds = timed(lambda: make_rule().acquire_single(space, model, dataset, generator=gen))
        launches[name] = fp.launches
        peak = torch.cuda.max_memory_allocated()
        spread = pairwise_min_distance(points)
        print(f"phase 12 {name}, {B} query points, on the Hartmann6 model (capacity {C}, "
              f"{N} seeds, {10 * D} runs): one acquire {seconds:.3f} s, kernel launches "
              f"{launches[name]}, reckoned peak {reckoned / 1e9:.3f} GB, max_memory_allocated "
              f"{peak / 1e9:.3f} GB, least distance between the points {spread:.3e}")
        if points.shape != (B, D) or not bool(space.contains(points).all()):
            fail(f"{name}: expected {B} points in the box, got {tuple(points.shape)}")
        if spread <= 1e-3:
            fail(f"{name}: the batch repeats a point")
        if name == "Fantasizer" and peak > 8e9:
            fail(f"the Fantasizer's acquire took {peak / 1e9:.3f} GB, over 8 GB")
    max_abs_err = max(max_abs_err, check_on_path("phase 12", model, space, N, gen))
    memory_line("phase 12", max(r[3] for r in rules), t_phase)
    return max_abs_err, launches


def active_learning(dev) -> dict:
    """Phase 13: predictive variance and expected feasibility learn what the JAX
    package's tests hold them to; one acquire of integrated variance reduction. Returns
    the kernel launches of each seed-0 run."""
    from trieste_tpu_torch.acquisition import (
        EfficientGlobalOptimization,
        ExpectedFeasibility,
        IntegratedVarianceReduction,
        PredictiveVariance,
        generate_continuous_optimizer,
    )
    from trieste_tpu_torch.objectives import Branin, ScaledBranin
    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    fast = generate_continuous_optimizer(num_initial_samples=512, num_optimization_runs=8)
    launches = {}

    def learn(label, problem, builder, steps, judge):
        space = problem.search_space.to(dev)

        def run_seed(seed):
            fp.launches = 0
            result, _, seconds = bo_run(
                lambda: EfficientGlobalOptimization(builder(), fast), problem, space, steps, seed,
                likelihood_variance=1e-5, num_initial=6, halton=True, stop_rtol=None,
            )
            model = result.try_get_final_model()
            test = space.sample(torch.Generator(device=dev).manual_seed(100 + seed), 4096)
            mean, _ = model.predict(test)
            value, limit, ok = judge(mean, problem.objective(test))
            print(f"phase 13 {label}, seed {seed}: {steps} steps, {seconds / steps:.3f} s/step, "
                  f"{value:.4f} (limit {limit}), kernel launches {fp.launches} "
                  f"{'ok' if ok else 'MISSED'}")
            return ok, (fp.launches, model, result.try_get_final_dataset(), space)

        launches[label], *rest = four_of_five(label, run_seed)
        return rest

    def max_error(mean, obs):
        share = float((mean - obs).abs().max() / (obs.max() - obs.min()))
        return share, 0.05, share < 0.05

    def level_set_accuracy(mean, obs):
        accuracy = float(((mean[:, 0] < 80.0) == (obs[:, 0] < 80.0)).double().mean())
        return accuracy, 0.9, accuracy > 0.9

    model, data, space = learn("PredictiveVariance on ScaledBranin, max error / range",
                               ScaledBranin, PredictiveVariance, 30, max_error)
    learn("ExpectedFeasibility(80.0) on Branin, level-set accuracy", Branin,
          lambda: ExpectedFeasibility(80.0), 15, level_set_accuracy)
    fp.launches = 0
    rule = EfficientGlobalOptimization(IntegratedVarianceReduction(space.sample_sobol(1000)))
    point, seconds = timed(lambda: rule.acquire_single(
        space, model, data, generator=torch.Generator(device=dev).manual_seed(13)))
    launches["IntegratedVarianceReduction acquire"] = fp.launches
    print(f"phase 13 IntegratedVarianceReduction over 1000 Sobol points, one acquire on the "
          f"predictive-variance model ({len(data)} points): {seconds:.3f} s, kernel launches "
          f"{fp.launches}, point {point.tolist()}")
    if point.shape != (1, 2) or not bool(space.contains(point).all()):
        fail(f"IntegratedVarianceReduction: expected one point in the box, got {tuple(point.shape)}")
    # IVR's seed scoring: the cross-covariance of 5000 seeds with the 1000 points, its solve
    memory_line("phase 13", 3 * 5000 * 1000 * 4, t_phase)
    return launches


def hold_kernel_on_pool(label, model, flat, chunk=131072):
    """The kernel in fp32 against its fp64 plain version on the fitted model at the rows
    ``flat [N, D]`` (the plain version in chunks of ``chunk`` rows); returns the larger max
    abs error of mean and var."""
    from trieste_tpu_torch.ops import fused_predict as fp

    params, cache = model.params, model.posterior_cache
    if not fp.can_fuse(params, cache, flat):
        fail(f"{label}: the fitted model does not pass the fused gate")
    ops = fp.operands(params, cache, flat)
    args = (ops[0],) + tuple(t.float().contiguous() for t in ops[1:])
    mean, var = fp.launch(*args)
    torch.cuda.synchronize()
    em = ev = 0.0
    ok = True
    for rows in torch.split(torch.arange(flat.shape[0], device=flat.device), chunk):
        plain = fp.fused_predict_reference(args[0], args[1][rows].double(),
                                           *(t.double() for t in args[2:]))
        cm, cv, _, _, chunk_ok = compare((mean[rows], var[rows]), plain)
        em, ev, ok = max(em, cm), max(ev, cv), ok and chunk_ok
    print(f"{label} kernel vs plain (fp64) on the fitted model ({args[0]}, N={flat.shape[0]} "
          f"C={args[2].shape[0]} live {int(cache.mask.sum())} D={flat.shape[1]}): mean abs "
          f"{em:.3e}, var abs {ev:.3e} {'ok' if ok else 'OUT OF TOLERANCE'}")
    if not ok:
        fail(f"{label}: kernel disagrees with its plain version on the pool")
    return max(em, ev)


def mixed_branin_space(dev):
    """ScaledBranin with its first dimension on a grid through the three minimizers'
    first coordinates (``tests/integration/test_mixed_space_bayesian_optimization.py:29-44``)."""
    import numpy as np

    from trieste_tpu_torch.objectives import ScaledBranin
    from trieste_tpu_torch.space import Box, DiscreteSearchSpace, TaggedProductSearchSpace

    minimizers0 = np.asarray(ScaledBranin.minimizers)[:, 0]
    step = (minimizers0[1] - minimizers0[0]) / 4
    points = np.concatenate([np.flip(np.arange(minimizers0[1], 0.0, -step))[:-1],
                             np.arange(minimizers0[1], 1.0, step)])
    return TaggedProductSearchSpace(
        [DiscreteSearchSpace(points[:, None], device=dev), Box([0.0], [1.0], device=dev)],
        ["discrete", "continuous"],
    )


def converge_trust_regions(dev, max_abs_err):
    """Phase 14: the trust-region rules to the minimum of ScaledBranin inside the reference
    budgets; the mixed-space product fleet; TREGO through Ask/Tell with a restart. Returns
    the running max abs error and the kernel launches of each first seed by rule."""
    from trieste_tpu_torch import AskTellOptimizer, stop_at_minimum
    from trieste_tpu_torch.acquisition import (
        BatchTrustRegionBox,
        BatchTrustRegionProduct,
        EfficientGlobalOptimization,
        FixedPointTrustRegionDiscrete,
        ParallelContinuousThompsonSampling,
        SingleObjectiveTrustRegionBox,
        TREGOBox,
        TURBOBox,
        UpdatableTrustRegionProduct,
        generate_continuous_optimizer,
    )
    from trieste_tpu_torch.objectives import ScaledBranin, mk_observer
    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    space = ScaledBranin.search_space.to(dev)
    minimum = float(ScaledBranin.minimum[0])
    stop = stop_at_minimum(ScaledBranin.minimum, ScaledBranin.minimizers,
                           minimum_rtol=SCALED_BRANIN_RTOL)
    ego = EfficientGlobalOptimization
    rules = (
        ("TREGO, BatchTrustRegionBox([TREGOBox]) with EI",
         lambda: BatchTrustRegionBox([TREGOBox(space)], ego()), 25, 1),
        ("TuRBO, BatchTrustRegionBox([TURBOBox]) with [EI]",
         lambda: BatchTrustRegionBox([TURBOBox(space)], [ego()]), 30, 1),
        ("BatchTrustRegionBox(init_subspaces=3) with its default MONLCB",
         lambda: BatchTrustRegionBox(init_subspaces=3), 15, 3),
    )
    launches, fleet = {}, {}
    for name, make_rule, budget, batch in rules:

        def run_seed(seed):
            fp.launches = 0
            result, evaluations, seconds = bo_run(make_rule, ScaledBranin, space, budget, seed,
                                                  likelihood_variance=TRUST_REGION_NOISE,
                                                  early_stop=stop)
            best = float(result.try_get_final_dataset().trimmed_observations.min())
            rel = relative_error(best, minimum)
            steps = evaluations // batch
            ok = rel <= SCALED_BRANIN_RTOL
            print(f"phase 14 {name} on ScaledBranin, seed {seed}: {steps} steps of {budget}, "
                  f"best {best:.6f}, rel err {rel:.3e} (limit {SCALED_BRANIN_RTOL}), "
                  f"{seconds / max(steps, 1):.3f} s/step, kernel launches {fp.launches} "
                  f"({fp.launches / max(steps, 1):.2f} per step) {'ok' if ok else 'MISSED'}")
            fleet[name] = result
            return ok, fp.launches

        launches[name] = four_of_five(name, run_seed)
        if launches[name] == 0:
            fail(f"{name}: the rule never launched the fused kernel")
    # the kernel on the batch fleet's seed pool: three regions' rows, from three boxes
    record = fleet[rules[2][0]].final_result.unwrap()
    gen = torch.Generator(device=dev).manual_seed(14)
    pool = record.acquisition_state.acquisition_space.sample(gen, 5000)
    max_abs_err = max(max_abs_err, hold_kernel_on_pool(
        "phase 14 batch fleet pool [5000, 3, 2]", record.model, pool.reshape(-1, 2)))

    # the mixed-space product fleet, as its JAX test sets it up
    mixed = mixed_branin_space(dev)
    observer = mk_observer(ScaledBranin.objective)

    def product_rule(seed):
        def region(i):
            return UpdatableTrustRegionProduct(
                [FixedPointTrustRegionDiscrete(
                    mixed.get_subspace("discrete"),
                    generator=torch.Generator(device=dev).manual_seed(100 * seed + i)),
                 SingleObjectiveTrustRegionBox(
                     mixed.get_subspace("continuous"),
                     generator=torch.Generator(device=dev).manual_seed(100 * seed + 50 + i))],
                tags=["discrete", "continuous"],
            )

        return BatchTrustRegionProduct(
            [region(i) for i in range(10)],
            ego(ParallelContinuousThompsonSampling(), num_query_points=10),
        )

    def run_product(seed):
        fp.launches = 0
        result, evaluations, seconds = bo_run(
            lambda: product_rule(seed), ScaledBranin, mixed, 8, seed, likelihood_variance=1e-7,
            stop_rtol=None)
        best = float(result.try_get_final_dataset().trimmed_observations.min())
        rel = relative_error(best, minimum)
        ok = rel <= SCALED_BRANIN_RTOL
        print(f"phase 14 BatchTrustRegionProduct (10 fixed-point x box regions, PCTS over 10 "
              f"points, likelihood variance 1e-7) on mixed ScaledBranin, seed {seed}: 8 steps, "
              f"best {best:.6f}, rel err {rel:.3e} (limit {SCALED_BRANIN_RTOL}), "
              f"{seconds / 8:.3f} s/step, kernel launches {fp.launches} {'ok' if ok else 'MISSED'}")
        return ok, fp.launches

    launches["BatchTrustRegionProduct, mixed space"] = four_of_five(
        "BatchTrustRegionProduct", run_product, first_seed=1)

    # TREGO through Ask/Tell, restarted from its state at round 10 of 20
    fast = generate_continuous_optimizer(num_initial_samples=512, num_optimization_runs=8)

    def trego_rule():
        return BatchTrustRegionBox([TREGOBox(space)], ego(optimizer=fast))

    def run_ask_tell(seed):
        from trieste_tpu_torch.models.gp import build_gpr

        fp.launches = 0
        gen = torch.Generator(device=dev).manual_seed(seed)
        initial = observer(space.sample(gen, 5))
        model = build_gpr(initial, space, likelihood_variance=TRUST_REGION_NOISE)
        ask_tell = AskTellOptimizer(space, initial, model, trego_rule(), generator=gen)
        t0 = time.perf_counter()
        for round_ in range(20):
            if round_ == 10:
                state = ask_tell.to_state(copy=True)
                ask_tell = AskTellOptimizer.from_state(state, space, trego_rule(), generator=gen)
                if len(ask_tell.dataset) != 15 or ask_tell.acquisition_state is None:
                    fail("TREGO Ask/Tell: the restored optimizer lost its data or its regions")
            points = ask_tell.ask()
            ask_tell.tell(observer(points.reshape(-1, points.shape[-1])))
        torch.cuda.synchronize()
        best = float(ask_tell.dataset.trimmed_observations.min())
        rel = relative_error(best, minimum)
        ok = rel <= SCALED_BRANIN_RTOL
        print(f"phase 14 TREGO through Ask/Tell (512 seeds, 8 runs, as the JAX test), restarted "
              f"from to_state/from_state at round 10, seed {seed}: 20 rounds, best {best:.6f}, rel "
              f"err {rel:.3e} (limit {SCALED_BRANIN_RTOL}), {(time.perf_counter() - t0) / 20:.3f} "
              f"s per round, kernel launches {fp.launches} {'ok' if ok else 'MISSED'}")
        return ok, fp.launches

    launches["TREGO through Ask/Tell"] = four_of_five("TREGO through Ask/Tell", run_ask_tell)
    # the largest tensors: PCTS's 10 trajectories of 1000 features at the 5000-seed pool
    # of the product fleet, the projection, its cosine and the contraction's copy
    memory_line("phase 14", 3 * 5000 * 10 * 1000 * 4, t_phase)
    return max_abs_err, launches


def recording_pools(store):
    """Make the fused path record ``(params, cache, rows)`` of every launch into ``store``;
    returns the function to put back."""
    from trieste_tpu_torch.ops import fused_predict as fp

    original = fp.fused_predict_f

    def recording(params, cache, flat):
        store.append((params, cache, flat))
        return original(params, cache, flat)

    fp.fused_predict_f = recording
    return original


def trust_region_fleet(model, dataset, space, dev, max_abs_err):
    """Phase 15: one filter and one acquire of a ten-region fleet at full width; returns the
    running max abs error and the acquire's kernel launches."""
    from trieste_tpu_torch.acquisition import (
        BatchTrustRegionBox,
        EfficientGlobalOptimization,
        MultipleOptimismNegativeLowerConfidenceBound,
        generate_continuous_optimizer,
    )
    from trieste_tpu_torch.acquisition.utils import with_local_datasets
    from trieste_tpu_torch.observer import OBJECTIVE
    from trieste_tpu_torch.ops import fused_predict as fp
    from trieste_tpu_torch.utils.misc import LocalizedTag

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    N, V, C, D = 131072, 10, dataset.capacity, space.dimension
    rule = BatchTrustRegionBox(init_subspaces=V, rule=EfficientGlobalOptimization(
        MultipleOptimismNegativeLowerConfidenceBound(space),
        generate_continuous_optimizer(num_initial_samples=N), num_query_points=V))
    rule.initialize_subspaces(space)
    models = {OBJECTIVE: model}
    datasets = with_local_datasets({OBJECTIVE: dataset}, V)
    (state, filtered), filter_s = timed(lambda: rule.filter_datasets(models, datasets)(None))
    for v, region in enumerate(state.subspaces):
        local = filtered[LocalizedTag(OBJECTIVE, v)]
        members = int((region.contains(dataset.query_points) & dataset.mask).sum())
        if local.capacity != C or local.num_points != (members or len(dataset)):
            fail(f"trust-region fleet: region {v}'s local dataset holds {local!r}, its region "
                 f"{members} of the points")
    recorded = []
    original = recording_pools(recorded)
    fp.launches = 0
    try:
        (state, points), acquire_s = timed(
            lambda: rule.acquire(space, models, filtered, generator=torch.Generator(
                device=dev).manual_seed(15))(state))
    finally:
        fp.fused_predict_f = original
    launches = fp.launches
    pools = [flat for _, _, flat in recorded]
    rows = [p.shape[0] for p in pools]
    peak = torch.cuda.max_memory_allocated()
    spread = pairwise_min_distance(points[0])
    inside = all(bool(region.contains(points[0, v])) for v, region in enumerate(state.subspaces))
    # the seed pool [N, V, D] and its scaled copy, the kernel's mean and variance, MONLCB's
    # scores and their copy with -inf for non-finite values
    reckoned = 2 * N * V * D * 4 + 4 * N * V * 4
    print(f"phase 15 BatchTrustRegionBox(init_subspaces={V}) with MONLCB over {V} points on the "
          f"Hartmann6 model (capacity {C}, {len(dataset)} points, {N} seeds, {10 * D} runs): "
          f"filter_datasets {filter_s:.3f} s, one acquire {acquire_s:.3f} s, kernel launches "
          f"{launches} over rows {rows}, least distance between the points {spread:.3e}, each in "
          f"its own region: {inside}; local datasets "
          f"{[filtered[LocalizedTag(OBJECTIVE, v)].num_points for v in range(V)]} of capacity {C}; "
          f"reckoned {reckoned / 1e9:.3f} GB, max_memory_allocated {peak / 1e9:.3f} GB")
    if tuple(points.shape) != (1, V, D) or spread <= 1e-6 or not inside:
        fail(f"trust-region fleet: expected {V} distinct points, each in its region")
    if launches != 1 or rows != [N * V]:
        fail(f"trust-region fleet: expected one launch over {N * V} rows, got {launches} over {rows}")
    memory_line("phase 15", reckoned, t_phase)
    max_abs_err = max(max_abs_err, hold_kernel_on_pool(
        f"phase 15 fleet pool [{N}, {V}, {D}]", model, pools[0]))
    # the kernel at the fleet's shape, beside its bound for the work these rows need
    args = fp.operands(model.params, model.posterior_cache, pools[0])
    fleet_ms = median_ms(lambda: fp.launch(*args), reps=10)
    _, _, fleet_bound_ms, bound_by, _, _ = bounds(N * V, int(model.posterior_cache.mask.sum()), C, D, 1)
    print(f"phase 15 kernel at the fleet's {N * V} rows: {fleet_ms:.3f} ms, bound {fleet_bound_ms:.3f} ms "
          f"({bound_by}), {100 * fleet_bound_ms / fleet_ms:.1f}% of bound")
    return max_abs_err, launches, fleet_ms


def stacked_model(data, space, likelihood_variance=None):
    """The reference's multi-objective model: a ``TrainableModelStack`` of one
    ``build_gpr`` per objective (``tests/integration/test_multi_objective_bayesian_optimization.py:31-38``)."""
    from trieste_tpu_torch import Dataset
    from trieste_tpu_torch.models import TrainableModelStack
    from trieste_tpu_torch.models.gp import build_gpr

    qp, obs = data.trimmed_query_points, data.trimmed_observations
    return TrainableModelStack(*[
        (build_gpr(Dataset.from_arrays(qp, obs[:, i:i + 1]), space,
                   likelihood_variance=likelihood_variance), 1)
        for i in range(obs.shape[-1])
    ])


def log_hv_difference(observations, problem, dev) -> float:
    """The reference's measure: the log of the hypervolume between the ideal front (100
    points) and the observed one, below the ideal front's reference point, in fp64."""
    from trieste_tpu_torch.acquisition.multi_objective import Pareto, get_reference_point

    ideal = problem.gen_pareto_optimal_points(100, device=dev).double()
    ref = get_reference_point(ideal)
    gap = Pareto(ideal).hypervolume_indicator(ref) - Pareto(
        observations.double()).hypervolume_indicator(ref)
    return float(torch.log(torch.clamp_min(gap, 1e-12)))


def vlmop2_rules():
    """Phase 16's VLMOP2 rules as the reference's test sets them up
    (``tests/integration/test_multi_objective_bayesian_optimization.py:71-110``):
    ``(name, rule factory, query points, steps, envelope on the log hypervolume
    difference)``."""
    from trieste_tpu_torch.acquisition import (
        HIPPO,
        BatchMonteCarloExpectedHypervolumeImprovement,
        EfficientGlobalOptimization,
        ExpectedHypervolumeImprovement,
        generate_continuous_optimizer,
    )

    ego, small = EfficientGlobalOptimization, generate_continuous_optimizer(num_initial_samples=500)
    return (
        ("EHVI", lambda: ego(ExpectedHypervolumeImprovement()), 1, 20, -3.65),
        ("qEHVI", lambda: ego(BatchMonteCarloExpectedHypervolumeImprovement(500), small, 2), 2,
         15, -3.44),
        ("HIPPO", lambda: ego(HIPPO(), small, 4), 4, 10, -3.2095),
    )


def converge_multi_objective(dev, max_abs_err):
    """Phase 16: the reference's VLMOP2 envelopes for EHVI, qEHVI(2) and HIPPO(4), and
    qHSRI(3) to the minimum of SimpleQuadratic. Returns the running max abs error and each
    rule's first-seed launches."""
    from types import SimpleNamespace

    from trieste_tpu_torch import BayesianOptimizer
    from trieste_tpu_torch.acquisition import BatchHypervolumeSharpeRatioIndicator
    from trieste_tpu_torch.objectives import VLMOP2, SimpleQuadratic, mk_observer
    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    space = VLMOP2.search_space.to(dev)
    observer = mk_observer(VLMOP2.objective)
    launches, first_pools = {}, []
    for name, make_rule, B, steps, envelope in vlmop2_rules():

        def run_seed(seed):
            gen = torch.Generator(device=dev).manual_seed(seed)
            initial = observer(torch.tensor(VLMOP2_DESIGNS[seed], device=dev).reshape(10, 2))
            model = stacked_model(initial, space, likelihood_variance=MULTI_OBJECTIVE_NOISE)
            pools = []
            original = recording_pools(pools)
            fp.launches = 0
            t0 = time.perf_counter()
            try:
                result = BayesianOptimizer(observer, space).optimize(
                    steps, initial, model, make_rule(), generator=gen, track_state=False)
            finally:
                fp.fused_predict_f = original
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if not result.is_ok:
                fail(f"phase 16 {name}: the run failed: {result.final_result.error!r}")
            data = result.try_get_final_dataset()
            diff = log_hv_difference(data.trimmed_observations, VLMOP2, dev)
            ratios = [float(m.params.noise_variance / m.params.kernel.variance) for m in model.models]
            ok = diff < envelope and len(data) == 10 + B * steps
            print(f"phase 16 {name} over {B} point(s) on VLMOP2, design {seed}: {steps} steps, log "
                  f"hv difference {diff:.4f} (envelope {envelope}), {seconds / steps:.3f} s/step, "
                  f"kernel launches {fp.launches}, members' noise/signal at the end "
                  f"{[f'{r:.3e}' for r in ratios]} {'ok' if ok else 'MISSED'}")
            if seed == 0:
                first_pools.extend(pools[:2])
            return ok, fp.launches

        launches[name] = four_of_five(f"phase 16 {name}", run_seed)
    if launches["EHVI"] == 0:
        fail("phase 16 EHVI never launched the fused kernel")
    for i, (params, cache, flat) in enumerate(first_pools):
        member = SimpleNamespace(params=params, posterior_cache=cache)
        max_abs_err = max(max_abs_err, hold_kernel_on_pool(
            f"phase 16 EHVI member {i}'s first pool", member, flat))

    quadratic = SimpleQuadratic.search_space.to(dev)
    minimum = float(SimpleQuadratic.minimum[0])

    def run_qhsri(seed):
        fp.launches = 0
        result, evaluations, seconds = bo_run(
            lambda: BatchHypervolumeSharpeRatioIndicator(3, ga_population_size=50,
                                                         ga_n_generations=15),
            SimpleQuadratic, quadratic, 6, seed, likelihood_variance=1e-7,
            stop_rtol=QHSRI_RTOL)
        best = float(result.try_get_final_dataset().trimmed_observations.min())
        rel, steps = relative_error(best, minimum), evaluations // 3
        ok = rel <= QHSRI_RTOL
        print(f"phase 16 qHSRI over 3 points on SimpleQuadratic, seed {seed}: {steps} steps of 6, "
              f"best {best:.6f}, rel err {rel:.3e} (limit {QHSRI_RTOL}), "
              f"{seconds / max(steps, 1):.3f} s/step, kernel launches {fp.launches} "
              f"{'ok' if ok else 'MISSED'}")
        return ok, fp.launches

    launches["qHSRI"] = four_of_five("phase 16 qHSRI", run_qhsri)
    # qEHVI's largest intermediate [seeds, S, K, T, B, M] at 500 seeds, 500 samples, its
    # cells K (at most the 40 points observed, plus one), 3 subsets of 2 points, 2 objectives
    memory_line("phase 16", 500 * 500 * 41 * 3 * 2 * 2 * 4, t_phase)
    return max_abs_err, launches


def multi_objective_full_width(dev, max_abs_err):
    """Phase 17: one acquire each of EHVI, HIPPO(4) and qEHVI(2) on a two-member stack at
    capacity 1024; returns the running max abs error and the launches by rule."""
    from trieste_tpu_torch.acquisition import (
        HIPPO,
        BatchMonteCarloExpectedHypervolumeImprovement,
        EfficientGlobalOptimization,
        ExpectedHypervolumeImprovement,
        generate_continuous_optimizer,
    )
    from trieste_tpu_torch.acquisition.multi_objective import Pareto
    from trieste_tpu_torch.objectives import DTLZ2, mk_observer
    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    problem = DTLZ2(6, 2)
    space = problem.search_space.to(dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    data = mk_observer(problem.objective)(space.sample(gen, 1000))
    model = stacked_model(data, space)
    _, fit_s = timed(lambda: model.optimize(data))
    C, D, N = data.capacity, space.dimension, 131072
    if any(m.dataset.capacity != C for m in model.models) or C != 1024:
        fail(f"phase 17: expected every member at capacity 1024, got "
             f"{[m.dataset.capacity for m in model.models]}")
    mean, _ = model.predict(data.trimmed_query_points)
    K = Pareto(mean).front.shape[0] + 1  # two objectives: one cell per front point, and one
    ego, wide = EfficientGlobalOptimization, generate_continuous_optimizer(num_initial_samples=N)
    # reckoned: the pool [N, D] and its scaled copy; per member the kernel's mean and
    # variance; the EHVI cell terms [N, K, M], about eight of them alive at once. HIPPO's
    # penalty adds per member the cross-covariance [N, C], its solve and their product's
    # operands, about four [N, C]. qEHVI at 500 seeds holds [500, S, K, T, B, M] arrays,
    # about four of them
    ehvi_bytes = 2 * N * D * 4 + 2 * 2 * N * 4 + 8 * N * K * 2 * 4
    rules = (
        ("EHVI", lambda: ego(ExpectedHypervolumeImprovement(), wide), 1, ehvi_bytes),
        ("HIPPO", lambda: ego(HIPPO(), wide, 4), 4, ehvi_bytes + 4 * N * C * 4),
        ("qEHVI", lambda: ego(BatchMonteCarloExpectedHypervolumeImprovement(500),
                              generate_continuous_optimizer(num_initial_samples=500), 2), 2,
         4 * 500 * 500 * K * 3 * 2 * 2 * 4),
    )
    launches = {}
    print(f"phase 17 DTLZ2(6, 2), 1000 points in a two-member stack (capacity {C}): fit "
          f"{fit_s:.3f} s; members' noise/signal "
          f"{[f'{float(m.params.noise_variance / m.params.kernel.variance):.3e}' for m in model.models]}; "
          f"{K} cells")
    for name, make_rule, B, reckoned in rules:
        torch.cuda.reset_peak_memory_stats()
        pools = []
        original = recording_pools(pools)
        fp.launches = 0
        try:
            points, seconds = timed(lambda: make_rule().acquire_single(space, model, data,
                                                                      generator=gen))
        finally:
            fp.fused_predict_f = original
        launches[name] = fp.launches
        peak = torch.cuda.max_memory_allocated()
        spread = pairwise_min_distance(points)
        print(f"phase 17 {name}, {B} query point(s), {N if name != 'qEHVI' else 500} seeds: one "
              f"acquire {seconds:.3f} s, kernel launches {launches[name]} over rows "
              f"{[int(f.shape[0]) for _, _, f in pools]}, reckoned peak {reckoned / 1e9:.3f} GB, "
              f"max_memory_allocated {peak / 1e9:.3f} GB, least distance between the points "
              f"{spread:.3e}")
        if tuple(points.shape) != (B, D) or not bool(space.contains(points).all()):
            fail(f"phase 17 {name}: expected {B} points in the box, got {tuple(points.shape)}")
        if B > 1 and spread <= 1e-6:
            fail(f"phase 17 {name}: the batch repeats a point")
        if name == "EHVI":
            if launches[name] != 2:
                fail(f"phase 17 EHVI: expected one launch per member, got {launches[name]}")
            for i, (member, (_, _, flat)) in enumerate(zip(model.models, pools)):
                max_abs_err = max(max_abs_err, hold_kernel_on_pool(
                    f"phase 17 EHVI member {i}'s pool", member, flat))
    memory_line("phase 17", max(r[3] for r in rules), t_phase)
    return max_abs_err, launches


def _gardner(x):
    """Gardner et al.'s simulation 1 (``tests/integration/test_constrained_bayesian_optimization.py``):
    the objective and the constraint, each ``[..., 1]``."""
    a, b = x[..., -2], x[..., -1]
    return ((torch.cos(2.0 * a) * torch.cos(b) + torch.sin(a))[..., None],
            (torch.cos(a) * torch.cos(b) - torch.sin(a) * torch.sin(b))[..., None])


def grid_feasible_minimum(problem, dev, n=2001):
    """The least objective value over the feasible points of an ``n × n`` grid of the unit
    square, and where it is."""
    g = torch.linspace(0.0, 1.0, n, dtype=torch.float64, device=dev)
    X = torch.stack(torch.meshgrid(g, g, indexing="ij"), dim=-1).reshape(-1, 2)
    space = problem.search_space.to(dev, torch.float64)
    y = torch.where(space.is_feasible(X), problem.objective(X)[:, 0], torch.inf)
    i = int(torch.argmin(y))
    return float(y[i]), X[i].tolist()


def converge_constraints(dev) -> dict:
    """Phase 18: constrained BO to the reference's envelopes; returns seed 0's kernel
    launches by rule."""
    from trieste_tpu_torch import BayesianOptimizer, Dataset
    from trieste_tpu_torch.acquisition import (
        EfficientGlobalOptimization,
        ExpectedConstrainedImprovement,
        ExpectedImprovement,
        FastConstraintsFeasibility,
        ProbabilityOfFeasibility,
    )
    from trieste_tpu_torch.models.gp import build_gpr
    from trieste_tpu_torch.objectives import ConstrainedScaledBranin, mk_observer
    from trieste_tpu_torch.observer import OBJECTIVE
    from trieste_tpu_torch.ops import fused_predict as fp
    from trieste_tpu_torch.space import Box

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    launches = {}

    # (a) Gardner ECI from the JAX test's design, 12 steps
    gardner_space = Box([0.0, 0.0], [6.0, 6.0], device=dev)
    minimizer = torch.tensor([1.5 * math.pi, 0.0], device=dev)

    def gardner_observer(qp):
        objective, constraint = _gardner(qp)
        return {OBJECTIVE: Dataset.from_arrays(qp, objective),
                "CONSTRAINT": Dataset.from_arrays(qp, constraint)}

    def gardner_best(datasets):
        obs = datasets[OBJECTIVE].trimmed_observations[:, 0]
        i = int(torch.argmin(obs))
        return float(obs[i]), datasets[OBJECTIVE].trimmed_query_points[i]

    def gardner_reached(datasets, _models=None, _state=None):
        best, at = gardner_best(datasets)
        return (abs(best + 2.0) <= SCALED_BRANIN_RTOL * 2.0
                and bool((torch.abs(at - minimizer) < 0.05).all()))

    def run_gardner(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        design = torch.tensor(GARDNER_DESIGN, device=dev).reshape(6, 2)
        initial = gardner_observer(design)
        models = {tag: build_gpr(initial[tag], gardner_space) for tag in initial}
        rule = EfficientGlobalOptimization(ExpectedConstrainedImprovement(
            OBJECTIVE, ProbabilityOfFeasibility(0.5).using("CONSTRAINT")))
        fp.launches = 0
        t0 = time.perf_counter()
        result = BayesianOptimizer(gardner_observer, gardner_space).optimize(
            12, initial, models, rule, generator=gen, track_state=False,
            early_stop_callback=gardner_reached)
        torch.cuda.synchronize()
        if not result.is_ok:
            fail(f"phase 18 Gardner ECI: the run failed: {result.final_result.error!r}")
        datasets = result.try_get_final_datasets()
        steps = len(datasets[OBJECTIVE]) - 6
        best, at = gardner_best(datasets)
        ok = gardner_reached(datasets)
        print(f"phase 18 Gardner ECI (JAX test design, two build_gpr models), generator seed "
              f"{seed}: {steps} steps of 12, best {best:.6f} at {at.tolist()}, rel err "
              f"{abs(best + 2.0) / 2.0:.3e} (limit {SCALED_BRANIN_RTOL}, minimizer within 0.05), "
              f"{(time.perf_counter() - t0) / max(steps, 1):.3f} s/step, kernel launches "
              f"{fp.launches} {'ok' if ok else 'MISSED'}")
        return ok, fp.launches

    launches["Gardner ECI"] = four_of_five("phase 18 Gardner ECI", run_gardner)

    # (b), (c) ConstrainedScaledBranin against the grid's feasible minimum, 20 steps
    problem = ConstrainedScaledBranin
    space = problem.search_space.to(dev)
    grid_min, grid_at = grid_feasible_minimum(problem, dev)
    print(f"phase 18 ConstrainedScaledBranin: feasible minimum on a 2001 x 2001 grid "
          f"{grid_min:.6f} at {grid_at} (the problem declares {float(problem.minimum[0])})")
    observer = mk_observer(problem.objective)

    def best_feasible(dataset):
        qp, obs = dataset.trimmed_query_points, dataset.trimmed_observations[:, 0]
        return float(torch.where(space.is_feasible(qp), obs, torch.inf).min())

    def reached(datasets, _models=None, _state=None):
        return relative_error(best_feasible(datasets[OBJECTIVE]), grid_min) <= SCALED_BRANIN_RTOL

    def constrained_run(name, make_builder):
        def run(seed):
            gen = torch.Generator(device=dev).manual_seed(seed)
            initial = observer(space.sample_feasible(gen, 5))
            fp.launches = 0
            t0 = time.perf_counter()
            result = BayesianOptimizer(observer, space).optimize(
                20, initial, build_gpr(initial, space), EfficientGlobalOptimization(make_builder()),
                generator=gen, track_state=False, early_stop_callback=reached)
            torch.cuda.synchronize()
            if not result.is_ok:
                fail(f"phase 18 {name}: the run failed: {result.final_result.error!r}")
            final = result.try_get_final_dataset()
            steps = len(final) - 5
            asked = final.trimmed_query_points[5:]
            if not bool(space.is_feasible(asked).all()):
                fail(f"phase 18 {name}: a query point is infeasible")
            best = best_feasible(final)
            rel = relative_error(best, grid_min)
            ok = rel <= SCALED_BRANIN_RTOL
            print(f"phase 18 {name} on ConstrainedScaledBranin, seed {seed}: {steps} steps of 20, "
                  f"every query point feasible, best feasible {best:.6f}, rel err {rel:.3e} to the "
                  f"grid's {grid_min:.6f} (limit {SCALED_BRANIN_RTOL}; the declared minimum "
                  f"{float(problem.minimum[0])}), {(time.perf_counter() - t0) / max(steps, 1):.3f} "
                  f"s/step, kernel launches {fp.launches} (one 5000-row feasible pool a step) "
                  f"{'ok' if ok else 'MISSED'}")
            return ok, fp.launches

        launches[name] = four_of_five(f"phase 18 {name}", run)

    constrained_run("EI", lambda: ExpectedImprovement(space))
    constrained_run("ECI with FastConstraintsFeasibility", lambda: ExpectedConstrainedImprovement(
        OBJECTIVE, FastConstraintsFeasibility(space).using(OBJECTIVE)))
    if min(launches.values()) <= 0:
        fail(f"phase 18: a rule never launched the fused kernel: {launches}")
    # the largest tensors: the 2001² grid in fp64 and its objective
    memory_line("phase 18", 2001 * 2001 * 2 * 8 * 3, t_phase)
    return launches


def constrained_full_width(model, dataset, dev, max_abs_err, N=131072):
    """Phase 19: one EI acquire over a linearly constrained Hartmann6 box at ``N`` feasible
    seeds; returns the running max abs error and the acquire's launches."""
    from trieste_tpu_torch.acquisition import (
        EfficientGlobalOptimization,
        ExpectedImprovement,
        generate_continuous_optimizer,
    )
    from trieste_tpu_torch.objectives import Hartmann6
    from trieste_tpu_torch.ops import fused_predict as fp
    from trieste_tpu_torch.space import Box, LinearConstraint

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    D = 6
    space = Box([0.0] * D, [1.0] * D, [LinearConstraint(torch.ones(1, D), 0.0, 2.0)], device=dev)
    minimizer_sum = float(Hartmann6.minimizers.sum())
    rule = EfficientGlobalOptimization(
        ExpectedImprovement(space), optimizer=generate_continuous_optimizer(num_initial_samples=N))
    pools = []
    original = recording_pools(pools)
    fp.launches = 0
    gen = torch.Generator(device=dev).manual_seed(19)
    try:
        point, seconds = timed(lambda: rule.acquire_single(space, model, dataset, generator=gen))
    finally:
        fp.fused_predict_f = original
    launches = fp.launches
    # reckoned: about 13 tries of N candidates [N, D] and their residuals [N, 2], the pool,
    # the kernel's mean and variance
    reckoned = 13 * N * (D + 2) * 4 + 2 * N * D * 4 + 2 * N * 4
    print(f"phase 19 EI on Hartmann6 (capacity {dataset.capacity}) over the box with "
          f"sum(x) <= 2 (the minimizer sums to {minimizer_sum:.3f}): one acquire at {N} feasible "
          f"seeds and 60 runs {seconds:.3f} s, point {point.tolist()} (sum "
          f"{float(point.sum()):.6f}), kernel launches {launches} over rows "
          f"{[int(f.shape[0]) for _, _, f in pools]}; the acquire's reckoned peak "
          f"{reckoned / 1e9:.3f} GB, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if point.shape != (1, D) or not bool(space.is_feasible(point).all()):
        fail(f"phase 19: expected one feasible point, got {point.tolist()}")
    if launches != 1 or int(pools[0][2].shape[0]) != N:
        fail(f"phase 19: expected one launch over the {N}-row feasible pool, got {launches}")
    pool = pools[0][2]
    if not bool(space.is_feasible(pool).all()):
        fail("phase 19: the seed pool holds an infeasible row")
    max_abs_err = max(max_abs_err, hold_kernel_on_pool("phase 19 feasible pool", model, pool))
    # the check's fp64 plain version holds [N, C] blocks: K, v and their products
    memory_line("phase 19 (with the check)", 4 * N * 1024 * 8, t_phase)
    return max_abs_err, launches


def converge_sparse(dev) -> dict:
    """Phase 20: SGPR and SVGP to the minimum of ScaledBranin inside the reference's
    budgets; returns seed 0's kernel launches by model (none is expected)."""
    from trieste_tpu_torch import BayesianOptimizer, stop_at_minimum
    from trieste_tpu_torch.acquisition import EfficientGlobalOptimization
    from trieste_tpu_torch.models.gp import (
        ConditionalImprovementReduction,
        build_sgpr,
        build_svgp,
    )
    from trieste_tpu_torch.objectives import ScaledBranin, mk_observer
    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    space = ScaledBranin.search_space.to(dev)
    observer = mk_observer(ScaledBranin.objective)
    minimum = float(ScaledBranin.minimum[0])
    launches = {}
    configs = (
        ("SGPR", lambda ds: build_sgpr(ds, space, num_inducing_points=50, likelihood_variance=1e-7,
                                       inducing_point_selector=ConditionalImprovementReduction()),
         14, 0.005),
        ("SVGP", lambda ds: build_svgp(ds, space, num_inducing_points=20, likelihood_variance=1e-6,
                                       trainable_likelihood=False), 40, 0.05),
    )
    for name, build, budget, rtol in configs:
        def run(seed, name=name, build=build, budget=budget, rtol=rtol):
            gen = torch.Generator(device=dev).manual_seed(seed)
            initial = observer(space.sample(gen, 6))
            fp.launches = 0
            t0 = time.perf_counter()
            result = BayesianOptimizer(observer, space).optimize(
                budget, initial, build(initial), EfficientGlobalOptimization(), generator=gen,
                track_state=False,
                early_stop_callback=stop_at_minimum(ScaledBranin.minimum, minimum_rtol=rtol))
            torch.cuda.synchronize()
            if not result.is_ok:
                fail(f"phase 20 {name}: the run failed: {result.final_result.error!r}")
            final = result.try_get_final_dataset()
            steps = len(final) - 6
            best = float(final.trimmed_observations.min())
            rel = relative_error(best, minimum)
            ok = rel <= rtol
            print(f"phase 20 {name} on ScaledBranin (fp32), seed {seed}: {steps} steps of {budget}, "
                  f"best {best:.6f}, rel err {rel:.3e} (limit {rtol}), "
                  f"{(time.perf_counter() - t0) / max(steps, 1):.3f} s/step, kernel launches "
                  f"{fp.launches} {'ok' if ok else 'MISSED'}")
            return ok, fp.launches

        launches[name] = four_of_five(f"phase 20 {name}", run)
    if any(launches.values()):
        fail(f"phase 20: a sparse model reached the exact GP's kernel: {launches}")
    memory_line("phase 20", 5000 * 50 * 4 * 4, t_phase)
    return launches


def sparse_full_width(dev, n=20000, M=500, N=131072) -> int:
    """Phase 21: SGPR, SVGP and decoupled inducing trajectories on Hartmann6 with ``n``
    observations and ``M`` inducing points, acquiring over ``N`` seeds or candidates;
    returns the kernel launches (none is expected)."""
    from trieste_tpu_torch.acquisition import (
        DiscreteThompsonSampling,
        EfficientGlobalOptimization,
        ThompsonSamplerFromTrajectory,
        generate_continuous_optimizer,
    )
    from trieste_tpu_torch.models.gp import ConditionalVarianceReduction, build_sgpr, build_svgp
    from trieste_tpu_torch.objectives import Hartmann6, mk_observer
    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    space = Hartmann6.search_space.to(dev)
    observer = mk_observer(Hartmann6.objective)
    gen = torch.Generator(device=dev).manual_seed(21)
    D, S, m = 6, 10, 1000
    data = observer(space.sample(gen, n))
    test_x = space.sample(gen, 1000)
    test_y = Hartmann6.objective(test_x)
    y_std = float(data.trimmed_observations.std())
    C = data.capacity
    ego = EfficientGlobalOptimization(optimizer=generate_continuous_optimizer(num_initial_samples=N))
    fp.launches = 0

    def step(label, fn, reckoned):
        torch.cuda.reset_peak_memory_stats()
        out, seconds = timed(fn)
        print(f"phase 21 {label}: {seconds:.3f} s, reckoned peak {reckoned / 1e9:.3f} GB, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        return out

    def held_out(label, model):
        mean, var = model.predict(test_x)
        if not (bool(torch.isfinite(mean).all()) and bool((var > 0).all())):
            fail(f"phase 21 {label}: a prediction is not finite or a variance not positive")
        rmse = float((mean - test_y).square().mean().sqrt())
        print(f"phase 21 {label}: RMSE at 1000 held-out points {rmse:.5f} against std(y) "
              f"{y_std:.5f} (limit {0.5 * y_std:.5f})")
        if rmse >= 0.5 * y_std:
            fail(f"phase 21 {label}: the model learned no more than the constant mean")

    def acquire(label, model):
        point = step(f"{label} EI acquire at {N} seeds and 60 runs",
                     lambda: ego.acquire_single(space, model, data, generator=gen),
                     3 * M * N * 4 + N * D * 4)
        if point.shape != (1, D) or not bool(space.contains(point).all()):
            fail(f"phase 21 {label}: expected one point in the box, got {tuple(point.shape)}")

    print(f"phase 21 Hartmann6, {n} observations (capacity {C}), {M} inducing points")
    sgpr = step("build_sgpr (k-means over the data)",
                lambda: build_sgpr(data, space, num_inducing_points=M,
                                   inducing_point_selector=ConditionalVarianceReduction()),
                n * M * D * 4 * 3)
    # the DPP's dense Gram [n, n] and its M incremental-Cholesky rows [M, n]
    step("SGPR selector update (ConditionalVarianceReduction, greedy DPP)",
         lambda: sgpr.update(data), n * n * 4 + M * n * 4)
    # per restart Kuf [M, C] and its solve, about six alive under autograd
    step("SGPR fit (5 restarts, inducing points trained)", lambda: sgpr.optimize(data),
         5 * 6 * M * C * 4)
    held_out("SGPR", sgpr)
    acquire("SGPR", sgpr)
    svgp = step("build_svgp (k-means over the data)",
                lambda: build_svgp(data, space, num_inducing_points=M, minibatch_size=1000),
                n * M * D * 4 * 3)
    step("SVGP fit (500 Adam steps on minibatches of 1000)", lambda: svgp.optimize(data),
         6 * M * 1000 * 4 + 3 * M * M * 4)
    held_out("SVGP", svgp)
    acquire("SVGP", svgp)
    # the features [N, S, m] (5.2 GB), their cosine and the contraction's copy; k(x, Z)
    # [N, S, M] (2.6 GB) and its distance terms
    thompson = DiscreteThompsonSampling(N, S, ThompsonSamplerFromTrajectory())
    points = step(f"DiscreteThompsonSampling({N}, {S}) from SGPR's decoupled inducing trajectories",
                  lambda: thompson.acquire_single(space, sgpr, data, generator=gen),
                  3 * N * S * m * 4 + 3 * N * S * M * 4)
    if points.shape != (S, D) or not bool(space.contains(points).all()):
        fail(f"phase 21 Thompson: expected {S} points in the box, got {tuple(points.shape)}")
    draws = sgpr.trajectory_sampler().get_trajectory(gen, S)(test_x[:, None, :].expand(1000, S, D))
    if not bool(torch.isfinite(draws).all()):
        fail("phase 21: a decoupled inducing trajectory is not finite")
    print(f"phase 21 {S} decoupled inducing trajectories at 1000 held-out points: finite, their "
          f"mean's RMSE {float((draws.mean(dim=1) - test_y).square().mean().sqrt()):.5f}; kernel "
          f"launches in the phase {fp.launches}")
    if fp.launches:
        fail(f"phase 21: a sparse model reached the exact GP's kernel ({fp.launches} launches)")
    print(f"phase 21 seconds: {time.perf_counter() - t_phase:.2f}")
    return fp.launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from trieste_tpu_torch import AskTellOptimizer, BayesianOptimizer, logging
    from trieste_tpu_torch.acquisition import (
        AsynchronousOptimization,
        BatchMonteCarloExpectedImprovement,
        DiscreteThompsonSampling,
        EfficientGlobalOptimization,
        MonteCarloExpectedImprovement,
        ParallelContinuousThompsonSampling,
        ThompsonSamplerFromTrajectory,
        generate_continuous_optimizer,
    )
    from trieste_tpu_torch.acquisition.function.function import _mc_ei_fn, _min_posterior_mean
    from trieste_tpu_torch.models.gp import build_gpr
    from trieste_tpu_torch.models.gp.posterior import (
        GPRParams,
        _predict_f_flat_reference,
        build_cache,
        predict_f,
        predict_f_reference,
    )
    from trieste_tpu_torch.models.gp.sampler import IndependentReparametrizationSampler
    from trieste_tpu_torch.objectives import Hartmann6, ScaledBranin, mk_observer
    from trieste_tpu_torch.ops import fused_predict as fp
    from trieste_tpu_torch.ops.kernels import stationary

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- phase 1: device ------------------------------------------------------------
    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    fp.library()
    print(f"phase 1 device: {smi}; TF32 off; kernel built and loaded in "
          f"{time.perf_counter() - t0:.2f} s ({fp.library_path().name})")
    print(f"phase 1 seconds: {time.perf_counter() - t_phase:.2f}")

    # -- phase 2: kernel against its plain version ----------------------------------
    t_phase = time.perf_counter()
    worst = [0.0, 0.0, 0.0, 0.0]
    # (D, N, P, C) by kind: the production grid with N not a multiple of the kernel's
    # 128-row block; the quickstart's shapes (D = 2, its 5000-point pool, capacities of one
    # partly filled LinvT tile); then, one kind each, the edges of the 32-row k tiles and
    # 128-column panels in C and of the 64-row warpgroups and 128-row blocks in N
    shapes = [(kind, 6, 3001, P, C) for kind in fp.KINDS for P in (1, 2, 8)
              for C in (100, 128, 1000, 1024)]
    shapes += [(kind, 2, 5000, 1, C) for kind in fp.KINDS for C in (8, 16, 32)]
    edge_C, edge_N = (8, 9, 31, 127, 129, 255, 256, 257, 513), (1, 63, 64, 65, 127, 129)
    shapes += [(fp.KINDS[i % 4], 6, 3001, 1, C) for i, C in enumerate(edge_C)]
    shapes += [(fp.KINDS[i % 4], 6, N, 2, 100) for i, N in enumerate(edge_N)]
    # input dimensions that are odd (padded to even), 1, above 8 (candidate rows in shared
    # memory) or above 96 (candidate and training rows read from global memory)
    edge_D = (1, 3, 5, 7, 8, 9, 12, 20, 129, 300)
    shapes += [(fp.KINDS[i % 4], D, 1000, 1, 100) for i, D in enumerate(edge_D)]
    cases = 0
    for kind, D, n_pool, P, C in shapes:
        params, cache, g = synthetic_state(kind, C, P, seed=1000 * P + C, device=dev, D=D)
        flat = torch.rand(n_pool, D, generator=g, dtype=torch.float64, device=dev)
        out, plain, _ = kernel_and_plain(params, cache, flat)
        em, ev, rm, rv, ok = compare(out, plain)
        worst = [max(a, b) for a, b in zip(worst, (em, ev, rm, rv))]
        cases += 1
        print(f"phase 2 {kind} D={D} P={P} C={C} N={n_pool}: mean abs {em:.3e} "
              f"rel {rm:.3e}, var abs {ev:.3e} rel {rv:.3e} "
              f"{'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            fail(f"kernel disagrees with its plain version: {kind} D={D} P={P} C={C} N={n_pool}")
    # One-hot operands: alpha = e_k makes mean[i] = K[i, k] + m and a LinvT whose only
    # non-zero row is k makes var[i] = σ² − K[i, k]²·Σ_j LinvT[k, j]², so a fragment whose
    # rows or k index were permuted would show in row i's outputs.
    one_hot = [(k, C, 6) for k, C in ((0, 64), (1, 64), (4, 64), (5, 64), (9, 64), (37, 64),
                                      (300, 1024), (1023, 1024))] + [(37, 64, 129), (300, 1024, 300)]
    for k, C, D in one_hot:
        g = torch.Generator(device=dev).manual_seed(k)
        scale = (6 / D) ** 0.5  # r² of the same order at every D
        spread = torch.linspace(0.25, 1.75, 257, device=dev)[:, None]  # and rows that differ
        xs = scale * spread * torch.rand(257, D, generator=g, device=dev)
        A = scale * torch.rand(C, D, generator=g, device=dev)
        alpha = torch.zeros(C, 1, device=dev)
        alpha[k] = 1.0
        LinvT = torch.zeros(C, C, device=dev)
        LinvT[k, k:] = torch.randn(C - k, generator=g, device=dev) / (C - k) ** 0.5
        scal = torch.tensor([1.7, 0.25], device=dev)
        em, ev, rm, rv, ok = compare(*raw_kernel_and_plain("rbf", xs, A, alpha, LinvT, scal))
        worst = [max(a, b) for a, b in zip(worst, (em, ev, rm, rv))]
        cases += 1
        print(f"phase 2 one-hot k={k} rbf D={D} P=1 C={C} N=257: mean abs {em:.3e}, var abs "
              f"{ev:.3e} {'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            fail(f"kernel disagrees with its plain version on one-hot operands: k={k} C={C} D={D}")
    print(f"phase 2 kernel vs plain (fp64): {cases} cases within mean rtol {MEAN_RTOL} atol "
          f"{MEAN_ATOL}, var rtol {VAR_RTOL} atol {VAR_ATOL}; max abs err mean {worst[0]:.3e} "
          f"var {worst[1]:.3e}, max rel err mean {worst[2]:.3e} var {worst[3]:.3e}")
    max_abs_err = max(worst[0], worst[1])

    # White-noise targets make |alpha| large, so rounding K to fp32 alone moves the mean
    # by about Σ_j|K_ij·alpha_j|·2^-24. This case is held to the contract or, where the
    # plain fp32 version breaks the contract too, to WHITE_NOISE_FACTOR times its error.
    params, cache, g = synthetic_state("rbf", 1024, 1, seed=7, device=dev, white_noise=True)
    flat = torch.rand(3001, 6, generator=g, dtype=torch.float64, device=dev)
    out, plain, args = kernel_and_plain(params, cache, flat)
    plain32 = fp.fused_predict_reference(*args)
    em, ev, rm, rv, ok = compare(out, plain)
    em32, ev32, _, _, ok32 = compare(plain32, plain)
    # K >= 0, so Σ_j|K_ij·alpha_j| is the mean of |alpha| with a zero mean constant
    no_mean = torch.tensor([1.0, 0.0], dtype=torch.float64, device=dev)
    spread = fp.fused_predict_reference(
        args[0], args[1].double(), args[2].double(), args[3].double().abs(),
        args[4].double(), args[5].double() * no_mean,
    )[0].max().item()
    white_noise_ok = ok or (em <= WHITE_NOISE_FACTOR * em32 and ev <= WHITE_NOISE_FACTOR * ev32)
    print(f"phase 2 white-noise rbf D=6 P=1 C=1024 N=3001 (max Σ|K·alpha| {spread:.3e}): "
          f"kernel mean abs {em:.3e} var abs {ev:.3e} "
          f"({'within' if ok else 'outside'} the contract); plain fp32 mean abs {em32:.3e} "
          f"var abs {ev32:.3e} ({'within' if ok32 else 'outside'} the contract) "
          f"{'ok' if white_noise_ok else 'WORSE THAN THE PLAIN FP32 VERSION'}")
    if not white_noise_ok:
        fail(f"white-noise case: kernel error beyond the contract and beyond "
             f"{WHITE_NOISE_FACTOR}x the plain fp32 version's")
    white_noise = {"abs_err": max(em, ev), "plain_fp32_abs_err": max(em32, ev32)}
    print(f"phase 2 seconds: {time.perf_counter() - t_phase:.2f}")

    # -- phase 3: production shape ------------------------------------------------
    t_phase = time.perf_counter()
    N, C, D, P = 131072, 1024, 6, 1
    g = torch.Generator(device=dev).manual_seed(42)
    Xtr = torch.rand(C, D, generator=g, device=dev)
    ds_y = Hartmann6.objective(Xtr)
    params = GPRParams(
        kernel=stationary("matern52", 1.0, [0.3] * D, dtype=torch.float32, device=dev),
        noise_variance=torch.tensor(1e-4, device=dev),
        mean_constant=torch.tensor(0.0, device=dev),
    )
    cache = build_cache(params, Xtr, ds_y, torch.ones(C, dtype=torch.bool, device=dev))
    flat = torch.rand(N, D, generator=g, device=dev)
    if not fp.can_fuse(params, cache, flat):
        fail("the production shape does not pass the fused gate")
    args = fp.operands(params, cache, flat)
    out = fp.launch(*args)
    torch.cuda.synchronize()
    plain64 = fp.fused_predict_reference(args[0], *(t.double() for t in args[1:]))
    em, ev, rm, rv, ok = compare(out, plain64)
    del plain64
    print(f"phase 3 kernel vs plain (fp64) at N={N} C={C}: mean abs {em:.3e}, var abs {ev:.3e}")
    if not ok:
        fail("kernel disagrees with its plain version at the production shape")
    max_abs_err = max(max_abs_err, em, ev)
    kernel_ms = median_ms(lambda: fp.launch(*args), reps=30)
    prologue_ms = median_ms(lambda: fp.pack(*args[2:5]), reps=30)
    plain_ms = median_ms(lambda: fp.fused_predict_reference(*args), reps=20)
    unfused_ms = median_ms(lambda: _predict_f_flat_reference(params, cache, flat), reps=20)
    flops, nbytes, bound_ms, bound_by, bound_ms_fp32_fma, bound_ms_bf16x3 = bounds(
        N, int(cache.mask.sum()), C, D, P
    )
    dense_ms = 2.0 * N * C * (C + D + P) / FP32_PEAK * 1e3  # all of LinvT, on the fp32 FMA pipes
    # every block of 128 rows streams the whole packed LinvT (hi and lo, the tiles on or
    # above the diagonal) from L2 once
    packed_bytes = fp.library().fused_predict_packed_bytes(C, D, P)
    l2_bytes = packed_bytes * ((N + 127) // 128)
    print(f"phase 3 production shape N={N} C={C} D={D} matern52 P={P}: kernel {kernel_ms:.3f} ms "
          f"(of which the prologue that splits and packs LinvT {prologue_ms:.3f} ms), "
          f"plain fp32 {plain_ms:.3f} ms, unfused torch (Gram, matmul, solve_triangular) "
          f"{unfused_ms:.3f} ms; bound {bound_ms:.3f} ms ({flops:.4e} FLOP needed, LinvT upper "
          f"triangular, {TF32_PASSES} TF32 products each at {TF32_PEAK / 1e12:.0f} TFLOP/s dense; "
          f"{nbytes:.4e} B at {HBM_RATE / 1e12:.2f} TB/s), bound by {bound_by} = "
          f"{100 * bound_ms / kernel_ms:.1f}% of bound; on the fp32 FMA pipes at "
          f"{FP32_PEAK / 1e12:.0f} TFLOP/s the bound was {bound_ms_fp32_fma:.3f} ms; with three "
          f"bf16 products each at {BF16_PEAK / 1e12:.0f} TFLOP/s, which the kernel does not use, "
          f"the floor is {bound_ms_bf16x3:.3f} ms = {100 * bound_ms_bf16x3 / kernel_ms:.1f}% of "
          f"the kernel's time; packed LinvT "
          f"{packed_bytes / 1e6:.3f} MB, read from L2 {l2_bytes / 1e9:.3f} GB per call")
    if bound_ms > kernel_ms:
        fail(f"the kernel ({kernel_ms:.3f} ms) beats its bound ({bound_ms:.3f} ms)")
    qs_params, qs_cache, g = synthetic_state("matern52", 32, 1, seed=3, device=dev, D=2)
    qs_flat = torch.rand(5000, 2, generator=g, dtype=torch.float64, device=dev)
    _, _, qs_args = kernel_and_plain(qs_params, qs_cache, qs_flat)
    quickstart_ms = median_ms(lambda: fp.launch(*qs_args), reps=30)
    print(f"phase 3 quickstart shape N=5000 C=32 D=2 matern52 P=1: kernel {quickstart_ms:.4f} ms")
    # the production shape at D = 12: the candidate rows are read from shared memory at
    # every k step instead of living in registers
    wide_D = 12
    w_params, w_cache, g = synthetic_state("matern52", C, 1, seed=5, device=dev, D=wide_D)
    w_flat = torch.rand(N, wide_D, generator=g, dtype=torch.float64, device=dev)
    w_out, w_plain, w_args = kernel_and_plain(w_params, w_cache, w_flat)
    em, ev, rm, rv, ok = compare(w_out, w_plain)
    del w_plain
    if not ok:
        fail(f"kernel disagrees with its plain version at N={N} C={C} D={wide_D}")
    max_abs_err = max(max_abs_err, em, ev)
    wide_ms = median_ms(lambda: fp.launch(*w_args), reps=20)
    print(f"phase 3 production shape at D={wide_D} (candidate rows in shared memory): kernel "
          f"{wide_ms:.3f} ms, mean abs {em:.3e}, var abs {ev:.3e}")
    # and at D = 128, beyond what shared memory holds: timing only, phase 2 checks D = 129
    far = (torch.rand(N, 128, generator=g, device=dev), torch.rand(C, 128, generator=g, device=dev),
           *w_args[3:])
    far_ms = median_ms(lambda: fp.launch("matern52", *far), reps=10)
    print(f"phase 3 production shape at D=128 (rows read from global memory): kernel {far_ms:.3f} ms")
    print(f"phase 3 seconds: {time.perf_counter() - t_phase:.2f}")

    # -- phase 4: main path, convergence ------------------------------------------
    t_phase = time.perf_counter()
    minimum = float(ScaledBranin.minimum[0])
    observer = mk_observer(ScaledBranin.objective)
    space = ScaledBranin.search_space  # on cuda, fp32
    gen = torch.Generator(device=dev).manual_seed(QUICKSTART_SEED)
    initial = observer(space.sample(gen, 5))
    model = build_gpr(initial, space)

    def reached(datasets, _models, _state=None):
        best = float(datasets["OBJECTIVE"].trimmed_observations.min())
        return abs(best - minimum) <= SCALED_BRANIN_RTOL * abs(minimum)

    fp.launches = 0
    t0 = time.perf_counter()
    result = BayesianOptimizer(observer, space).optimize(
        QUICKSTART_STEPS, initial, model, generator=gen, early_stop_callback=reached
    )
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    quickstart_launches = fp.launches
    if not result.is_ok:
        fail(f"the quickstart failed: {result.final_result.error!r}")
    qp, best, _ = result.try_get_optimal_point()
    steps = len(result.try_get_final_dataset()) - 5
    rel_err = abs(float(best) - minimum) / abs(minimum)
    print(f"phase 4 ScaledBranin quickstart (seed {QUICKSTART_SEED}, default-noise build_gpr, "
          f"fp32): {steps} steps, best {float(best):.6f} at {qp.tolist()}, rel err {rel_err:.3e} "
          f"(limit {SCALED_BRANIN_RTOL}), {seconds / max(steps, 1):.3f} s/step, "
          f"kernel launches {quickstart_launches}")
    if rel_err > SCALED_BRANIN_RTOL:
        fail(f"ScaledBranin not within rtol {SCALED_BRANIN_RTOL} in {QUICKSTART_STEPS} steps")
    if quickstart_launches <= 0:
        fail("the quickstart never launched the fused kernel")
    max_abs_err = max(max_abs_err, check_on_path("phase 4", model, space, 5000, gen))
    print(f"phase 4 seconds: {time.perf_counter() - t_phase:.2f}")

    # -- phase 5: main path, full width --------------------------------------------
    t_phase = time.perf_counter()

    class Wallclock:
        """Summary writer that keeps the loop's wall-clock scalars."""

        def __init__(self):
            self.values = {}

        def add_scalar(self, name, value, step):
            self.values.setdefault(name, []).append((step, value))

    observer = mk_observer(Hartmann6.objective)
    space = Hartmann6.search_space
    gen = torch.Generator(device=dev).manual_seed(1)
    initial = observer(space.sample(gen, 1000))
    model = build_gpr(initial, space)
    rule = EfficientGlobalOptimization(
        optimizer=generate_continuous_optimizer(num_initial_samples=131072)
    )
    writer = Wallclock()
    logging.set_tensorboard_writer(writer)
    fp.launches = 0
    t0 = time.perf_counter()
    result = BayesianOptimizer(observer, space).optimize(
        2, initial, model, rule, generator=gen, track_state=False
    )
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    full_width_launches = fp.launches
    logging.set_tensorboard_writer(None)
    if not result.is_ok:
        fail(f"the full-width run failed: {result.final_result.error!r}")
    final = result.try_get_final_dataset()
    qp, obs = final.astuple()
    if len(final) != 1002 or final.capacity != 1024:
        fail(f"expected 1002 points in capacity 1024, got {final!r}")
    if not (bool(torch.isfinite(obs).all()) and bool(space.contains(qp).all())):
        fail("the full-width run produced non-finite observations or points outside the box")
    mean, var = predict_f(model.params, model.posterior_cache, qp[-2:])
    if not (bool(torch.isfinite(mean).all()) and bool((var > 0).all())):
        fail("the fitted full-width model predicts non-finite values")
    fits = [v for _, v in writer.values.get("wallclock/model_fitting", [])]
    acquires = [v for _, v in writer.values.get("wallclock/query_point_generation", [])]
    print(f"phase 5 Hartmann6 full width (1000 initial points, capacity 1024, 131072 seeds, "
          f"2 steps): {seconds:.2f} s in all; initial fit {fits[0]:.2f} s; per step fit "
          f"{[round(v, 3) for v in fits[1:]]} s, acquisition {[round(v, 3) for v in acquires]} s; "
          f"best {float(obs.min()):.5f}; kernel launches {full_width_launches}")
    if full_width_launches < 2:
        fail(f"expected at least 2 kernel launches at full width, got {full_width_launches}")
    max_abs_err = max(max_abs_err, check_on_path("phase 5", model, space, 131072, gen))
    print(f"phase 5 seconds: {time.perf_counter() - t_phase:.2f}")

    hartmann_space, hartmann_observer, hartmann_data = space, observer, initial
    hartmann_model, hartmann_final = model, final

    # -- phase 6: Ask/Tell with a batch rule at full width ---------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    S, B, C = 1000, 4, 1024
    D = hartmann_space.dimension
    n_seeds, n_runs = max(5000, 1000 * B * D), 10 * B * D
    # seed scoring predicts jointly at n_seeds*B points: the cross-covariance [n, C], its
    # transpose, the solve's result and its reshaped copy, and their product's operands;
    # then the samples [n_seeds, S, B], their permuted copy and the improvement
    reckoned = 5 * n_seeds * B * C * 4 + 3 * n_seeds * S * B * 4
    gen = torch.Generator(device=dev).manual_seed(6)
    model = build_gpr(hartmann_data, hartmann_space)
    rule = EfficientGlobalOptimization(BatchMonteCarloExpectedImprovement(S), num_query_points=B)
    fp.launches = 0
    ask_tell, fit_s = timed(
        lambda: AskTellOptimizer(hartmann_space, hartmann_data, model, rule, generator=gen)
    )
    ask_s, tell_s = [], []
    for _ in range(2):
        points, seconds = timed(ask_tell.ask)
        ask_s.append(seconds)
        if points.shape != (B, D) or not bool(hartmann_space.contains(points).all()):
            fail(f"Ask/Tell batch: expected {B} points in the box, got {tuple(points.shape)}")
        if len(torch.unique(points, dim=0)) != B:
            fail("Ask/Tell batch: the batch repeats a point")
        _, seconds = timed(lambda: ask_tell.tell(hartmann_observer(points)))
        tell_s.append(seconds)
    fitted = model.params
    restored = AskTellOptimizer.from_state(
        ask_tell.to_state(), hartmann_space,
        EfficientGlobalOptimization(BatchMonteCarloExpectedImprovement(S), num_query_points=B),
        generator=gen,
    )
    points, seconds = timed(restored.ask)
    ask_s.append(seconds)
    same_fit = restored.model.params is fitted and all(
        torch.equal(a, b) for a, b in (
            (restored.model.params.kernel.lengthscales, fitted.kernel.lengthscales),
            (restored.model.params.kernel.variance, fitted.kernel.variance),
            (restored.model.params.noise_variance, fitted.noise_variance),
        )
    )
    same_data = len(restored.dataset) == 1000 + 2 * B and torch.equal(
        restored.dataset.query_points, ask_tell.dataset.query_points
    ) and torch.equal(restored.dataset.observations, ask_tell.dataset.observations)
    if not (same_fit and same_data and restored.dataset.capacity == C):
        fail("Ask/Tell batch: the restored optimizer refitted or holds other data")
    if points.shape != (B, D) or not bool(torch.isfinite(points).all()):
        fail("Ask/Tell batch: the restored optimizer's ask failed")
    ask_tell_launches = fp.launches
    print(f"phase 6 Ask/Tell Hartmann6 (1000 initial points, capacity {C}, "
          f"BatchMonteCarloExpectedImprovement({S}), {B} query points, {n_seeds} seeds and "
          f"{n_runs} runs in {B * D}-D): initial fit {fit_s:.3f} s; s per ask "
          f"{[round(v, 3) for v in ask_s]} (the last from the restored state), s per tell "
          f"{[round(v, 3) for v in tell_s]}; best {float(restored.dataset.trimmed_observations.min()):.5f}; "
          f"restored: same data, no refit; kernel launches {ask_tell_launches}")
    memory_line("phase 6", reckoned, t_phase)

    # -- phase 7: Monte-Carlo EI through the kernel -----------------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    S = 2000
    data = restored.dataset
    n_seeds = max(5000, 1000 * D)
    reckoned = 3 * n_seeds * S * 4 + 2 * n_seeds * C * 4
    fp.launches = 0
    mc_rule = EfficientGlobalOptimization(MonteCarloExpectedImprovement(S))
    mc_ask_tell = AskTellOptimizer(hartmann_space, data, model, mc_rule, generator=gen,
                                   fit_model=False)
    point, mc_ask_s = timed(mc_ask_tell.ask)
    mc_ei_launches = fp.launches
    if mc_ei_launches < 1:
        fail("Monte-Carlo EI: the ask did not launch the fused kernel")
    if point.shape != (1, D) or not bool(hartmann_space.contains(point).all()):
        fail(f"Monte-Carlo EI: expected one point in the box, got {tuple(point.shape)}")
    # the same scores by hand: eps drawn here, the kernel path (fp32, no_grad, a pool above
    # the fused gate) against the exact prediction in fp64
    eps = torch.randn(S, 1, 1, generator=gen, device=dev)
    eta = _min_posterior_mean(model, data)
    # half of the pool lies around the best observed points, where the improvement is not
    # zero in every sample
    best_rows = torch.argsort(data.trimmed_observations[:, 0])[:8]
    near = data.trimmed_query_points[best_rows].repeat(n_seeds // 16, 1)
    near = near + 0.03 * torch.randn(near.shape, generator=gen, device=dev)
    near = torch.clamp(near, hartmann_space.lower, hartmann_space.upper)
    pool = torch.cat([hartmann_space.sample(gen, n_seeds - near.shape[0]), near])
    before = fp.launches
    with torch.no_grad():
        sampler = IndependentReparametrizationSampler(S, model, eps=eps)
        got = _mc_ei_fn(sampler.sample, eta, pool[:, None, :])[:, 0].double()
    if fp.launches != before + 1:
        fail("Monte-Carlo EI: scoring the seed pool did not launch the fused kernel")
    p64, c64 = fp64_state(model.params, model.dataset)
    mean64, var64 = predict_f_reference(p64, c64, pool.double())  # [N, 1]
    samples64 = mean64[:, None, :] + torch.sqrt(var64)[:, None, :] * eps[:, 0, :].double()
    want = torch.clamp_min(eta.double() - samples64, 0.0).mean(dim=1)[:, 0]
    # |ΔEI| <= |Δmean| + E|eps|·|Δsqrt(var)| and |sqrt(a) − sqrt(b)| <= sqrt(|a − b|)
    mean_abs_eps = float(eps.abs().mean())
    limit = (MEAN_ATOL + MEAN_RTOL * mean64[:, 0].abs()
             + mean_abs_eps * torch.sqrt(VAR_ATOL + VAR_RTOL * var64[:, 0]))
    err = (got - want).abs()
    print(f"phase 7 Monte-Carlo EI ({S} samples, {n_seeds} seeds): ask {mc_ask_s:.3f} s, kernel "
          f"launches {mc_ei_launches}; seed scores through the kernel against the exact fp64 "
          f"prediction with the same eps: max abs err {float(err.max()):.3e} (scores up to "
          f"{float(want.max()):.3e}, {int((want > 0).sum())} of them above 0), limit |Δmean| + E|eps|·sqrt(|Δvar|) from the kernel's "
          f"contract, at least {float(limit.min()):.3e}")
    if not bool((err <= limit).all()):
        fail("Monte-Carlo EI: the kernel path's scores are outside the contract pushed through EI")
    if int((want > 0).sum()) < 100:
        fail("Monte-Carlo EI: the pool's scores are zero nearly everywhere, the check shows nothing")
    max_abs_err = max(max_abs_err, check_on_path("phase 7", model, hartmann_space, n_seeds, gen))
    memory_line("phase 7", reckoned, t_phase)

    # -- phase 8: Thompson sampling, convergence --------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    observer = mk_observer(ScaledBranin.objective)
    space = ScaledBranin.search_space
    # the exact sampler factorizes a [1000, 1000] joint covariance; PCTS evaluates 4
    # trajectories of 1000 features at a 5000-point seed pool
    reckoned = max(4 * 1000 * 1000 * 4, 3 * 5000 * 4 * 1000 * 4)

    def thompson_run(make_rule, budget, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        initial = observer(space.sample(gen, 5))
        t0 = time.perf_counter()
        result = BayesianOptimizer(observer, space).optimize(
            budget, initial, build_gpr(initial, space), make_rule(), generator=gen,
            early_stop_callback=reached, track_state=False,
        )
        torch.cuda.synchronize()
        if not result.is_ok:
            fail(f"the Thompson run failed: {result.final_result.error!r}")
        final = result.try_get_final_dataset()
        best = float(final.trimmed_observations.min())
        return best, len(final) - 5, time.perf_counter() - t0

    thompson = {}
    for name, make_rule, budget, batch in (
        ("DiscreteThompsonSampling(1000, 5)", lambda: DiscreteThompsonSampling(1000, 5), 25, 5),
        ("ParallelContinuousThompsonSampling, 4 query points", lambda: EfficientGlobalOptimization(
            ParallelContinuousThompsonSampling(), num_query_points=4), 20, 4),
    ):
        runs = []
        for seed in range(5):
            best, evaluations, seconds = thompson_run(make_rule, budget, seed)
            rel = relative_error(best, minimum)
            runs.append(rel <= SCALED_BRANIN_RTOL)
            steps = evaluations // batch
            print(f"phase 8 {name} on ScaledBranin, seed {seed}: {steps} steps of {budget}, best "
                  f"{best:.6f}, rel err {rel:.3e} (limit {SCALED_BRANIN_RTOL}), "
                  f"{seconds / max(steps, 1):.3f} s/step {'ok' if runs[-1] else 'MISSED'}")
            if seed == 0:
                thompson[name] = steps
                if runs[0]:
                    break
        if not runs[0] and sum(runs) < 4:
            fail(f"{name}: {sum(runs)} of 5 seeds within rtol {SCALED_BRANIN_RTOL} in {budget} steps")
    memory_line("phase 8", reckoned, t_phase)

    # -- phase 9: the asynchronous rule through Ask/Tell --------------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    S, B, rounds = 1000, 2, 20
    n_seeds = max(5000, 1000 * B * 2)
    # up to 2 pending points ride in front of every candidate batch
    reckoned = 3 * n_seeds * S * (B + 2) * 4 + 5 * n_seeds * (B + 2) * 128 * 4
    def asynchronous_run(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        initial = observer(space.sample(gen, 5))
        ask_tell = AskTellOptimizer(
            space, initial, build_gpr(initial, space),
            AsynchronousOptimization(BatchMonteCarloExpectedImprovement(S), num_query_points=B),
            generator=gen,
        )
        late, most_pending, used, ask_s, tell_s = None, 0, rounds, [], []
        for round_ in range(1, rounds + 1):
            points, seconds = timed(ask_tell.ask)
            ask_s.append(seconds)
            most_pending = max(most_pending, ask_tell.acquisition_state.pending_points.shape[0])
            arrived = points[:1] if late is None else torch.cat([late, points[:1]])
            late = points[1:]  # observed one round late
            _, seconds = timed(lambda: ask_tell.tell(observer(arrived)))
            tell_s.append(seconds)
            if reached(ask_tell.datasets, None):
                used = round_
                break
        best = float(ask_tell.dataset.trimmed_observations.min())
        rel = relative_error(best, minimum)
        ok = rel <= SCALED_BRANIN_RTOL
        print(f"phase 9 AsynchronousOptimization(BatchMonteCarloExpectedImprovement({S}), {B} "
              f"query points) on ScaledBranin through Ask/Tell, one point told a round late, "
              f"seed {seed}: {used} rounds of {rounds}, best {best:.6f}, rel err {rel:.3e} (limit "
              f"{SCALED_BRANIN_RTOL}), up to {most_pending} pending points, median s per ask "
              f"{statistics.median(ask_s):.3f}, per tell {statistics.median(tell_s):.3f} "
              f"{'ok' if ok else 'MISSED'}")
        if most_pending < 3:
            fail("the asynchronous state never held a point beyond the batch just asked")
        return ok, used, ask_tell.dataset

    ok, asynchronous_rounds, branin = asynchronous_run(0)
    if not ok:  # as in phase 8: the budget stays, four of five seeds must meet it
        passed = sum(asynchronous_run(seed)[0] for seed in range(1, 5))
        if passed < 4:
            fail(f"the asynchronous rule: {passed} of 5 seeds within rtol {SCALED_BRANIN_RTOL} "
                 f"in {rounds} rounds")
    memory_line("phase 9", reckoned, t_phase)

    # -- phase 10: Thompson sampling at full width --------------------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    S, m = 10, model.num_rff_features
    budget_bytes = torch.cuda.get_device_properties(0).total_memory / 4

    def feature_bytes(n):  # the projection, its cosine and the contraction's copy, fp32
        return 3 * n * S * m * 4

    n_candidates = 2
    while feature_bytes(2 * n_candidates) <= budget_bytes:
        n_candidates *= 2
    gen = torch.Generator(device=dev).manual_seed(10)
    rule = DiscreteThompsonSampling(n_candidates, S, ThompsonSamplerFromTrajectory())
    points, seconds = timed(
        lambda: rule.acquire_single(hartmann_space, model, restored.dataset, generator=gen)
    )
    if points.shape != (S, D) or not bool(hartmann_space.contains(points).all()):
        fail(f"Thompson full width: expected {S} points in the box, got {tuple(points.shape)}")
    print(f"phase 10 DiscreteThompsonSampling({n_candidates}, {S}, ThompsonSamplerFromTrajectory()) "
          f"on the Hartmann6 model (capacity {C}, {m} features): one acquire {seconds:.3f} s, "
          f"{len(torch.unique(points, dim=0))} distinct points, best posterior mean "
          f"{float(model.predict(points)[0].min()):.5f}")
    # the trajectories themselves, at a sample of the candidates: finite, and their mean
    # over the draws follows the posterior mean (capacity above the feature count: the
    # weight posterior took the design-matrix route)
    x = hartmann_space.sample(gen, 4096)
    draws = model.trajectory_sampler().get_trajectory(gen, 64)(x[:, None, :].expand(4096, 64, D))
    post_mean, post_var = model.predict(x)
    if not bool(torch.isfinite(draws).all()):
        fail("Thompson full width: a trajectory on the Hartmann6 model is not finite")
    corr = float(torch.corrcoef(torch.stack([draws[..., 0].mean(dim=1), post_mean[:, 0]]))[0, 1])
    print(f"phase 10 64 trajectories at 4096 points of the Hartmann6 model: finite; their mean "
          f"against the posterior mean: correlation {corr:.4f}, rms difference "
          f"{float((draws[..., 0].mean(dim=1) - post_mean[:, 0]).square().mean().sqrt()):.4f}; "
          f"their std {float(draws[..., 0].std(dim=1).mean()):.4f} against the posterior's "
          f"{float(post_var.sqrt().mean()):.4f}")
    if corr < 0.5:
        fail("Thompson full width: the trajectories' mean does not follow the posterior mean")
    # tiny noise in fp32: the README's fixed-noise recipe, capacity below the feature
    # count, so the weight posterior takes the kernel-trick route
    gen = torch.Generator(device=dev).manual_seed(0)
    tiny = build_gpr(branin, space, likelihood_variance=1e-7)
    tiny.optimize(branin)
    x = space.sample(gen, 4096)[:, None, :].expand(4096, 8, 2)
    for seed in range(10):
        out = tiny.trajectory_sampler().get_trajectory(gen, 8)(x)
        if out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
            fail(f"a trajectory at likelihood variance 1e-7 is not finite (draw {seed})")
    print(f"phase 10 trajectories at likelihood variance 1e-7 in fp32 ({len(branin)} points, "
          f"capacity {branin.capacity}, {tiny.num_rff_features} features): 10 draws of 8 finite")
    memory_line("phase 10", feature_bytes(n_candidates), t_phase)

    families_launches = converge_families(dev)
    max_abs_err, batches_launches = full_width_batches(
        hartmann_model, hartmann_final, hartmann_space, dev, max_abs_err
    )
    active_learning_launches = active_learning(dev)
    max_abs_err, trust_region_launches = converge_trust_regions(dev, max_abs_err)
    max_abs_err, fleet_launches, fleet_ms = trust_region_fleet(
        hartmann_model, hartmann_final, hartmann_space, dev, max_abs_err
    )
    max_abs_err, multi_objective_launches = converge_multi_objective(dev, max_abs_err)
    max_abs_err, multi_objective_full_width_launches = multi_objective_full_width(dev, max_abs_err)
    print(f"phases 1-17 seconds: {time.perf_counter() - t_start:.2f}")
    t_new = time.perf_counter()
    constraints_launches = converge_constraints(dev)
    max_abs_err, constrained_full_width_launches = constrained_full_width(
        hartmann_model, hartmann_final, dev, max_abs_err
    )
    sparse_launches = converge_sparse(dev)
    sparse_full_width_launches = sparse_full_width(dev)
    print(f"phases 18-21 seconds: {time.perf_counter() - t_new:.2f}; phases 1-21 seconds: "
          f"{time.perf_counter() - t_start:.2f}")

    # -- phase 22: kernels -----------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "fused_predict",
        "route": "cuda",
        "source": "trieste_tpu_torch/csrc/fused_predict.cu",
        "replaces": "trieste_tpu/ops/fused_predict.py:163",
        "launches": full_width_launches,
        "launches_quickstart": quickstart_launches,
        "launches_ask_tell_batch": ask_tell_launches,
        "launches_monte_carlo_ei_ask": mc_ei_launches,
        "launches_families_convergence": families_launches,
        "launches_full_width_batches": batches_launches,
        "launches_active_learning": active_learning_launches,
        "launches_trust_regions": trust_region_launches,
        "launches_trust_region_fleet": fleet_launches,
        "launches_multi_objective": multi_objective_launches,
        "launches_multi_objective_full_width": multi_objective_full_width_launches,
        "launches_constraints": constraints_launches,
        "launches_constrained_full_width": constrained_full_width_launches,
        "launches_sparse_models": sparse_launches,
        "launches_sparse_full_width": sparse_full_width_launches,
        "max_abs_err": max_abs_err,
        "white_noise_abs_err": white_noise["abs_err"],
        "white_noise_plain_fp32_abs_err": white_noise["plain_fp32_abs_err"],
        "ms": kernel_ms,
        "prologue_ms": prologue_ms,
        "ms_quickstart_shape": quickstart_ms,
        "plain_ms": plain_ms,
        "unfused_torch_ms": unfused_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_rate": f"TF32 tensor cores, {TF32_PASSES} products per needed product, "
                      f"{TF32_PEAK / 1e12:.0f} TFLOP/s dense",
        "bound_ms_fp32_fma": bound_ms_fp32_fma,
        "bound_ms_bf16x3": bound_ms_bf16x3,
        "ms_wide_shape": wide_ms,
        "ms_trust_region_fleet_shape": fleet_ms,
        "ms_global_rows_shape": far_ms,
        "bound_ms_dense": dense_ms,
        "route_detail": "wgmma tf32x3",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
