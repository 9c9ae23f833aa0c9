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
16. multi-objective BO to the reference's envelopes (each run stops once its envelope is
   met: adding points never raises the log hypervolume difference)
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
22. classification to convergence, as the reference's active-learning classification
   tutorial sets it up: labels ``sum(x²) > 0.5`` on [-1, 1]², ``build_vgp_classifier`` from
   10 labelled points, ``EfficientGlobalOptimization(BayesianActiveLearningByDisagreement())``
   for 15 steps; the held-out accuracy at 10,000 Halton points at least the JAX package's
   worst over seeds 0 to 4 (``CLASSIFICATION_ACCURACY``); seeds as in phase 8; no kernel
   launch (the VGP predicts in its whitened form). It prints the final ELBO and the
   natural-gradient steps that fp32 rejected;
23. the VGP at full width: 1000 labelled circle points (capacity 1024), one fit whose ELBO
   must rise, one BALD acquire at 131,072 seeds and 60 runs beside the reckoned bytes of
   the prediction's three [131072, 1024] tensors; then a Poisson VGP fit at the JAX float32
   test's shape, finite in fp32; no kernel launch;
24. multifidelity BO to convergence as the JAX package's integration test sets it up
   (``tests/integration/test_multifidelity_bayesian_optimization.py:28-80``): Linear2Fidelity
   from 12 and 8 points, ``build_multifidelity_autoregressive_models``,
   ``Product(MUMBO, CostWeighting([2, 4]))`` over 512 seeds and 8 runs for 6 steps; the best
   top-fidelity point within 5% of the minimizer and its value within rtol 0.1 of the
   minimum; seeds as in phase 8;
25. multifidelity and encoded models at full width: AR(1) on Linear3Fidelity at a nested
   design of 1000/250/60 points (capacities 1024/256/64, `build_gpr`'s default noise), one
   fit and one MUMBO × CostWeighting acquire at 131,072 seeds and 60 runs, whose pool score
   launches the kernel three times for each level the fused gate admits (level 0 and at
   least one other: a residual level of the linear problems is linear in x, and its fit
   climbs a ridge that can end under the gate's noise/signal ratio); NARGP on the first two fidelities, whose upper level
   predicts its 32 × 131,072 propagated rows in one launch; an encoded GPR (Hartmann6 with
   two categorical dimensions, one-hot to 12) with one EI acquire at 131,072 seeds, one
   launch. The kernel is held against its fp64 plain version on every level's pool, on the
   propagated rows and on the encoded pool;
26. the fully-Bayesian GP to convergence as the JAX package's integration test sets it up
   (``tests/integration/test_model_bayesian_optimization.py:54-57,66-69,110,120-136``):
   ScaledBranin from 6 points, ``build_gpr_mcmc`` at a likelihood variance of 1e-6 with 3
   chains of 15 samples and 10 retained, EGO with ``MonteCarloExpectedImprovement(500)``
   and the default optimizer, within 20 steps to rtol 0.005 (seeds as in phase 8); each
   run prints its HMC fit and acquire seconds apart and each fit's mean accept rate, step
   sizes and non-finite log-posterior evaluations; no kernel launch, though its 5000-row
   pools would pass the gate (the mixture predicts by the exact path);
27. the fully-Bayesian GP at full width: phase 5's Hartmann6 data (1000 points, capacity
   1024), ``build_gpr_mcmc`` at its defaults (4 chains of 25 samples after 100 of warmup,
   20 retained), one timed fit; the mixture at 131,072 pool rows held against the fp64
   plain mixture on the same samples and factors (the contract's tolerance), and its error
   against fp64 factors printed beside phase 5's GP's; one MC EI acquire at 131,072 seeds
   with its peak memory beside the bytes reckoned; no kernel launch;
28. summaries, profiling and objectives: a three-step quickstart with a JSON-lines writer
   must write the JAX loop's summary names at every step (``QUICKSTART_SUMMARIES_*``), each
   flush making one device-to-host transfer (counted in the sync debug mode); a profiler
   trace of one more step must name a CUDA kernel; every objective added with this phase
   (``NEW_OBJECTIVES``) on the card at its minimizers within 1e-5·max(1, |f|) of its fp64
   value on the CPU;
29. the deep models to convergence as the JAX package's integration test sets them up
   (``tests/integration/test_model_bayesian_optimization.py:48-53,61-65,71-86,107-109``):
   ScaledBranin from 6 points, EGO with PCTS over 4 points and the default optimizer,
   ``build_vanilla_deep_gp(num_layers=2, num_train_steps=800)`` within 25 steps and
   ``build_deep_ensemble(ensemble_size=5, num_train_steps=600)`` within 60, both to rtol
   0.05 (seeds as in phase 8); each run prints its steps, best value, s/step with the fits
   and the acquisitions apart, the final training loss, the non-finite losses of its fits
   and its kernel launches (none: neither model predicts by the exact GP);
30. the deep models at full width: phase 5's Hartmann6 data (1000 points, capacity 1024),
   each builder at its defaults (the deep GP: 2 layers, 100 inducing points, width 6, 2000
   Adam steps, 64 predict samples; the ensemble: 5 members of (25, 25), 1000 steps with the
   bootstrap): one timed fit, one prediction at 131,072 rows and one PCTS acquire of 4
   points at 131,072 seeds and 60 runs, each with its peak memory beside the bytes
   reckoned; no kernel launch; then an import of the experimental plotting, which finds
   neither matplotlib nor plotly on a machine without them;
31. multi-device (``trieste_tpu_torch.parallel``): (a) phase 5's full-width EI acquire
   (its fitted model and data, 131,072 seeds, 60 runs) under a mesh of one rank, first with
   no process group and then in a one-rank NCCL group: the same point bit for bit, the same
   kernel launches and no collective call; (b) two child processes on the one card, joined
   by a gloo group (NCCL takes one rank per GPU), which load the kernel the parent built:
   ``fit_gpr`` with 10 restarts, five a rank, against the parent's unsharded fit from the
   same draws; one EI acquire at 131,072 seeds, the kernel on each rank's 65,536 rows held
   against its fp64 plain version and the point against the parent's unsharded one; and a
   3000-row pool (1500 rows a rank), which must launch the kernel once, as unsharded. Each
   rank prints its seconds, launches and the bytes it received; two ranks time-share one
   card, so those seconds say nothing of scaling;
32. the tutorials (``examples_torch/``): each of the 14 in this process on ``cuda`` at its
   smallest budget (``main(1)``, or ``main()`` for the two without one), with the kernel
   phase 1 built; each prints its seconds, kernel launches and returned dict, which must
   hold finite numbers and pass the example's own checks (the Ask/Tell resume asks for the
   uninterrupted run's point bit for bit, the flaky observer's first run is an ``Err`` and
   its resume ``Ok``, the explicitly constrained point is feasible, the EHVI front is
   non-dominated, the mixed space's point is on its grid); the launches must equal
   ``EXAMPLE_LAUNCHES``, written from the fused gate before the first card run, and the
   kernel is held against its fp64 plain version on every pool an example scored;
33. one JSON line describing each kernel. Its ``max_abs_err`` covers every case held to
   the contract, including the kernel on the fitted models that phases 4 to 7, 12, 14 to
   17, 19, 25, 31 and 32 leave behind; the white-noise case has keys of its own.

Run with ``--multi-device-rank RANK WORLD COORDINATOR DIRECTORY``, the script is one of
phase 31's child processes.

Phases 6 to 32 each print their seconds and phases 11 to 32 their kernel launches; phases 6
to 21, 23, 25 to 27 and 29 to 30 the bytes reckoned for their largest tensors and
``torch.cuda.max_memory_allocated()``.

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

# The summary names the JAX package's loop writes in a three-step quickstart with a writer
# and the default filter (an exact GP on ScaledBranin, EGO with EI): at step 0, and at each
# step after it. Phase 28 holds the port's loop to them; tests/test_torch_logging.py checks
# them against the JAX loop.
QUICKSTART_SUMMARIES_AT_STEP_0 = ("metadata", "model.training_loss", "wallclock/model_fitting")
QUICKSTART_SUMMARIES_PER_STEP = (
    "EGO.query_points", "OBJECTIVE.observation/best_new_observation",
    "OBJECTIVE.observation/best_overall", "OBJECTIVE.observation/new_observations",
    "OBJECTIVE.query_points/[0]", "OBJECTIVE.query_points/[1]", "accuracy/absolute_error",
    "accuracy/mean_absolute_error", "accuracy/observations", "accuracy/observations_mean",
    "accuracy/observations_variance", "accuracy/predict_mean", "accuracy/predict_mean__mean",
    "accuracy/predict_variance", "accuracy/predict_variance__mean",
    "accuracy/root_mean_square_error", "accuracy/root_mean_variance_error",
    "accuracy/variance_error", "accuracy/z_residuals", "accuracy/z_residuals_std",
    "kernel.lengthscale[0]", "kernel.lengthscale[1]", "kernel.variance", "likelihood.variance",
    "model.training_loss", "spo_af_evaluations", "spo_improvement_on_initial_samples",
    "wallclock/model_fitting", "wallclock/observation", "wallclock/query_point_generation",
    "wallclock/step",
)
# Phase 26: the GPR-MCMC envelope of the JAX package's integration test
# (tests/integration/test_model_bayesian_optimization.py:54-57,66-69,110,120-136)
GPR_MCMC_STEPS = 20
GPR_MCMC_MC_SAMPLES = 500
GPR_MCMC_CONFIG = dict(likelihood_variance=1e-6, num_chains=3, num_samples_per_chain=15,
                       num_retained=10)
# Phase 28: the objectives added with the fully-Bayesian GP, held on the card at their
# minimizers to their fp64 values within this multiple of max(1, |f|), about 80 float32 ulps
NEW_OBJECTIVES = ("GramacyLee", "LogarithmicGoldsteinPrice", "Hartmann3", "Shekel4", "Levy8",
                  "Rosenbrock4", "Ackley5", "Michalewicz2", "Michalewicz5", "Michalewicz10",
                  "Trid10")
OBJECTIVE_FP32_RTOL = 1e-5
# Phase 29: the deep models' envelopes of the JAX package's integration test
# (tests/integration/test_model_bayesian_optimization.py:48-53,61-65,107-109)
DEEP_GP_STEPS = 25
DEEP_ENSEMBLE_STEPS = 60
DEEP_MODEL_RTOL = 0.05
# Phase 31: two ranks share the card; the fit's restarts, the seed and the gate's pool
MULTI_DEVICE_RANKS = 2
MULTI_DEVICE_FIT_STARTS = 10
MULTI_DEVICE_SEED = 31
MULTI_DEVICE_GATE_POOL = 3000
MULTI_DEVICE_TIMEOUT = 300
# The sharded fit and acquire against the unsharded ones from the same draws. In fp32 the
# card's batched products round by batch size (cuBLAS picks its kernels by shape), so the
# L-BFGS runs of 5 restarts (30 acquisition runs) a rank stop elsewhere on a flat optimum
# than those of 10 (60) in one batch: 2.0e-6 of the loss, 1.1e-3 in a log-parameter and
# 2.3e-4 in the point on the H100. The fit is held bit for bit to unsharded fits of the
# ranks' blocks and by its loss to the one-batch fit; the point by its distance, as the
# JAX test holds a rounded pool (tests/unit/test_parallel.py:151-153), and by its EI
MULTI_DEVICE_FIT_LOSS_RTOL = 1e-5
MULTI_DEVICE_POINT_ATOL = 1e-3
MULTI_DEVICE_EI_RTOL = 1e-4
COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_reduce", "broadcast", "reduce",
               "gather", "scatter", "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
               "all_to_all_single", "barrier", "all_gather_object", "broadcast_object_list")
# Phase 32: the tutorials of examples_torch/, each at its smallest budget
EXAMPLES = (
    "active_learning", "ask_tell_optimization", "batch_optimization", "deep_models",
    "expected_improvement", "inequality_constraints", "mixed_search_spaces",
    "multi_chip_scaling", "multi_objective_ehvi", "multifidelity_modelling",
    "recovering_from_errors", "thompson_sampling", "trust_region", "visualizing_and_logging",
)
EXAMPLES_WITHOUT_BUDGET = ("multifidelity_modelling", "recovering_from_errors")
# Their kernel launches, predicted from the fused gate before the first card run (a pool
# of at least MIN_POINTS rows, capacity at most 1024, a noise/signal ratio of at least
# 1e-5 after the fit; PERF.md §6): Gardner ECI's two default-noise models score the
# step's 5000-row pool once each, as do EHVI's two members at noise 1e-5; every example at
# noise 1e-7 is under the ratio, active learning's Branin GPs (noise 1e-5 against a kernel
# variance in the thousands) too, and the deep, sparse and multifidelity models score no
# 2048-row pool with an exact GP. Every other example: 0
EXAMPLE_LAUNCHES = {"inequality_constraints": 2, "multi_objective_ehvi": 2}


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


def hold_kernel_on_pool(label, model, flat, chunk=131072, fp32_floor=False):
    """The kernel in fp32 against its fp64 plain version on the fitted model at the rows
    ``flat [N, D]`` (the plain version in chunks of ``chunk`` rows); returns the larger max
    abs error of mean and var. With ``fp32_floor``, a model whose scale puts the plain fp32
    version outside the contract too (the contract's atol is for a kernel variance of
    order 1) is held, as phase 2's white-noise case, to ``WHITE_NOISE_FACTOR`` times the
    plain fp32 version's error."""
    from trieste_tpu_torch.ops import fused_predict as fp

    params, cache = model.params, model.posterior_cache
    if not fp.can_fuse(params, cache, flat):
        fail(f"{label}: the fitted model does not pass the fused gate")
    ops = fp.operands(params, cache, flat)
    args = (ops[0],) + tuple(t.float().contiguous() for t in ops[1:])
    mean, var = fp.launch(*args)
    torch.cuda.synchronize()
    em = ev = em32 = ev32 = 0.0
    ok = ok32 = True
    for rows in torch.split(torch.arange(flat.shape[0], device=flat.device), chunk):
        plain = fp.fused_predict_reference(args[0], args[1][rows].double(),
                                           *(t.double() for t in args[2:]))
        cm, cv, _, _, chunk_ok = compare((mean[rows], var[rows]), plain)
        em, ev, ok = max(em, cm), max(ev, cv), ok and chunk_ok
        if fp32_floor:
            cm, cv, _, _, chunk_ok = compare(fp.fused_predict_reference(
                args[0], args[1][rows], *args[2:]), plain)
            em32, ev32, ok32 = max(em32, cm), max(ev32, cv), ok32 and chunk_ok
    floor = ""
    if fp32_floor:
        floor = (f"; plain fp32 mean abs {em32:.3e}, var abs {ev32:.3e} "
                 f"({'within' if ok32 else 'outside'} the contract)")
        ok = ok or (em <= WHITE_NOISE_FACTOR * em32 and ev <= WHITE_NOISE_FACTOR * ev32)
    print(f"{label} kernel vs plain (fp64) on the fitted model ({args[0]}, N={flat.shape[0]} "
          f"C={args[2].shape[0]} live {int(cache.mask.sum())} D={flat.shape[1]}, variance "
          f"{float(params.kernel.variance):.4g}): mean abs {em:.3e}, var abs {ev:.3e}{floor} "
          f"{'ok' if ok else 'OUT OF TOLERANCE'}")
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

            # adding points never raises the log hv difference, so the envelope holds after
            # the budget if and only if it holds where the run stops
            def met(datasets, _models, _state=None, envelope=envelope):
                observed = datasets["OBJECTIVE"].trimmed_observations
                return log_hv_difference(observed, VLMOP2, dev) < envelope

            try:
                result = BayesianOptimizer(observer, space).optimize(
                    steps, initial, model, make_rule(), generator=gen, track_state=False,
                    early_stop_callback=met)
            finally:
                fp.fused_predict_f = original
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if not result.is_ok:
                fail(f"phase 16 {name}: the run failed: {result.final_result.error!r}")
            data = result.try_get_final_dataset()
            diff = log_hv_difference(data.trimmed_observations, VLMOP2, dev)
            ratios = [float(m.params.noise_variance / m.params.kernel.variance) for m in model.models]
            used, left = divmod(len(data) - 10, B)
            ok = diff < envelope and left == 0 and used <= steps
            print(f"phase 16 {name} over {B} point(s) on VLMOP2, design {seed}: {used} steps of "
                  f"{steps}, log hv difference {diff:.4f} (envelope {envelope}), "
                  f"{seconds / max(used, 1):.3f} s/step, "
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


CLASSIFICATION_STEPS = 15
# The worst held-out accuracy of the JAX package on phase 22's problem at that depth, seeds
# 0 to 4 on the CPU in float32 (0.9108, 0.8876, 0.8926, 0.9245, 0.9546), from
# ``python3 tools/classification_threshold.py --seeds 0 5 --steps 15``
CLASSIFICATION_ACCURACY = 0.8876
# The JAX test's steps (tests/integration/test_multifidelity_bayesian_optimization.py:45-80)
MULTIFIDELITY_STEPS = 6


def circle_observer(x: torch.Tensor):
    """0/1 labels of ``sum(x²) > 0.5`` on [-1, 1]² (the reference's active-learning
    classification tutorial)."""
    from trieste_tpu_torch import Dataset

    return Dataset.from_arrays(x, (x.square().sum(-1, keepdim=True) > 0.5).to(x.dtype))


def vgp_fits(model):
    """Keep every fit result of ``model`` (for its rejected natural-gradient steps)."""
    results, optimize = [], model.optimize
    model.optimize = lambda dataset: results.append(optimize(dataset)) or results[-1]
    return results


def converge_classification(dev, steps=CLASSIFICATION_STEPS) -> int:
    """Phase 22: BALD on the VGP classifier for ``steps`` steps from 10 labelled circle
    points, held-out accuracy on a 10,000-point Halton grid against the JAX package's;
    returns seed 0's kernel launches (none is expected: the VGP never reaches the kernel)."""
    from trieste_tpu_torch import BayesianOptimizer
    from trieste_tpu_torch.acquisition import (
        BayesianActiveLearningByDisagreement,
        EfficientGlobalOptimization,
    )
    from trieste_tpu_torch.models.gp import build_vgp_classifier
    from trieste_tpu_torch.models.gp.vgp import vgp_elbo
    from trieste_tpu_torch.ops import fused_predict as fp
    from trieste_tpu_torch.space import Box

    t_phase = time.perf_counter()
    space = Box([-1.0, -1.0], [1.0, 1.0], device=dev)
    grid = space.sample_halton(None, 10_000)
    truth = circle_observer(grid).trimmed_observations[:, 0] > 0.5

    def run(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        initial = circle_observer(space.sample(gen, 10))
        model = build_vgp_classifier(initial, space)
        fits = vgp_fits(model)
        fp.launches = 0
        t0 = time.perf_counter()
        result = BayesianOptimizer(circle_observer, space).optimize(
            steps, initial, model,
            EfficientGlobalOptimization(BayesianActiveLearningByDisagreement()),
            generator=gen, track_state=False,
        )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not result.is_ok:
            fail(f"phase 22: the run failed: {result.final_result.error!r}")
        final = result.try_get_final_dataset()
        labels = final.trimmed_observations
        if len(final) != 10 + steps or not bool(((labels == 0) | (labels == 1)).all()):
            fail(f"phase 22: expected {10 + steps} points with 0/1 labels, got {final!r}")
        prob, _ = model.predict_y(grid)
        accuracy = float(((prob[:, 0] > 0.5) == truth).float().mean())
        data = model.get_internal_data()
        elbo = float(vgp_elbo(model.params, data.query_points, data.observations, data.mask))
        rejected = sum(int(r.rejected_steps) for r in fits)
        rejected_hyper = sum(int(r.rejected_hyper_steps) for r in fits)
        ok = accuracy >= CLASSIFICATION_ACCURACY
        print(f"phase 22 BALD on the VGP classifier (circle, fp32), seed {seed}: {steps} steps, "
              f"capacity {data.capacity}, held-out accuracy {accuracy:.4f} at 10000 Halton points "
              f"(JAX package's worst of seeds 0-4: {CLASSIFICATION_ACCURACY}), final ELBO "
              f"{elbo:.4f}, {len(fits)} fits, rejected natural-gradient steps {rejected} of "
              f"{len(fits) * 55} and hyperparameter runs {rejected_hyper} of {len(fits) * 10}, "
              f"{seconds / steps:.3f} s/step, kernel launches {fp.launches} "
              f"{'ok' if ok else 'MISSED'}")
        return ok, fp.launches

    launches = four_of_five("phase 22", run)
    if launches:
        fail(f"phase 22: the VGP reached the exact GP's kernel ({launches} launches)")
    print(f"phase 22 seconds: {time.perf_counter() - t_phase:.2f}")
    return launches


def vgp_full_width(dev, n=1000, N=131072) -> int:
    """Phase 23: the VGP classifier on ``n`` labelled circle points (capacity 1024), one fit
    and one BALD acquire at ``N`` seeds and 60 runs; then a Poisson VGP fit at the JAX
    float32 test's shape. Returns the kernel launches (none is expected)."""
    from trieste_tpu_torch import Dataset
    from trieste_tpu_torch.acquisition import (
        BayesianActiveLearningByDisagreement,
        EfficientGlobalOptimization,
        generate_continuous_optimizer,
    )
    from trieste_tpu_torch.models.gp import PoissonLikelihood, VariationalGaussianProcess, VGPParams
    from trieste_tpu_torch.models.gp import build_vgp_classifier
    from trieste_tpu_torch.models.gp.vgp import vgp_elbo
    from trieste_tpu_torch.ops import fused_predict as fp
    from trieste_tpu_torch.ops.kernels import stationary
    from trieste_tpu_torch.space import Box

    t_phase = time.perf_counter()
    space = Box([-1.0, -1.0], [1.0, 1.0], device=dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    data = circle_observer(space.sample(gen, n))
    C = data.capacity
    model = build_vgp_classifier(data, space)
    args = (data.query_points, data.observations, data.mask)
    fp.launches = 0
    before = float(vgp_elbo(model.params, *args))
    result, fit_s = timed(lambda: model.optimize(data))
    after = float(vgp_elbo(model.params, *args))
    print(f"phase 23 VGP classifier, {n} circle points (capacity {C}): fit {fit_s:.3f} s, ELBO "
          f"{before:.4f} -> {after:.4f}, rejected natural-gradient steps "
          f"{int(result.rejected_steps)} of 55 and hyperparameter runs "
          f"{int(result.rejected_hyper_steps)} of 10 (fp32)")
    if not after > before:
        fail("phase 23: the fit did not raise the ELBO")
    rule = EfficientGlobalOptimization(
        BayesianActiveLearningByDisagreement(),
        generate_continuous_optimizer(num_initial_samples=N, num_optimization_runs=60),
    )
    torch.cuda.reset_peak_memory_stats()
    point, acquire_s = timed(lambda: rule.acquire_single(space, model, data, generator=gen))
    # vgp_predict_f's three [N, C] fp32 tensors at the seed pool: k(x, X), L⁻¹k and q_sqrtᵀL⁻¹k
    reckoned = 3 * N * C * 4
    print(f"phase 23 BALD acquire at {N} seeds and 60 runs: {acquire_s:.3f} s, reckoned "
          f"{reckoned / 1e9:.3f} GB, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; kernel launches {fp.launches}")
    if point.shape != (1, 2) or not bool(space.contains(point).all()):
        fail(f"phase 23: expected one point in the box, got {tuple(point.shape)}")
    # the JAX float32 test's Poisson VGP (tests/integration/test_float32_loop.py:87-125)
    Xp = torch.linspace(-1, 1, 16, device=dev)[:, None]
    counts = Dataset.from_arrays(Xp, torch.ones(16, 1, device=dev))
    poisson = VariationalGaussianProcess(VGPParams(
        kernel=stationary("matern52", 1.0, [0.5], device=dev),
        mean_constant=torch.zeros((), device=dev), q_mu=torch.zeros(16, 1, device=dev),
        q_sqrt=torch.eye(16, device=dev), likelihood=PoissonLikelihood(),
    ), counts, num_alternations=2)
    fitted, poisson_s = timed(lambda: poisson.optimize(counts))
    rate, rate_var = poisson.predict_y(Xp[:4])
    leaves = [fitted.params.q_mu, fitted.params.q_sqrt, fitted.params.kernel.variance, rate, rate_var]
    if not all(t.dtype == torch.float32 and bool(torch.isfinite(t).all()) for t in leaves):
        fail("phase 23: the Poisson VGP's fit or rate is not finite fp32")
    print(f"phase 23 Poisson VGP (16 points, 2 alternations, fp32): fit {poisson_s:.3f} s, rate "
          f"{[round(v, 4) for v in rate[:, 0].tolist()]}, rejected steps "
          f"{int(fitted.rejected_steps)}; kernel launches in the phase {fp.launches}")
    if fp.launches:
        fail(f"phase 23: the VGP reached the exact GP's kernel ({fp.launches} launches)")
    print(f"phase 23 seconds: {time.perf_counter() - t_phase:.2f}")
    return fp.launches


def nested_fidelity_design(problem, sizes, gen):
    """Fidelity ``f`` at the first ``sizes[f]`` of ``sizes[0]`` input points."""
    from trieste_tpu_torch.data import add_fidelity_column
    from trieste_tpu_torch.objectives import mk_observer

    x = problem.search_space.sample(gen, sizes[0])
    qp = torch.cat([add_fidelity_column(x[:n], f) for f, n in enumerate(sizes)])
    return mk_observer(problem.objective)(qp)


def fidelity_costs(num_fidelities):
    """The JAX test's observation costs, ``2(f + 1)`` at fidelity ``f``."""
    return [2.0 * (f + 1) for f in range(num_fidelities)]


def mumbo_rule(space, gen, num_fidelities, num_initial_samples, num_optimization_runs):
    from trieste_tpu_torch.acquisition import (
        MUMBO,
        CostWeighting,
        EfficientGlobalOptimization,
        Product,
        generate_continuous_optimizer,
    )

    acquisition = Product(MUMBO(space, generator=gen).using("OBJECTIVE"),
                          CostWeighting(fidelity_costs(num_fidelities)).using("OBJECTIVE"))
    return EfficientGlobalOptimization(acquisition, generate_continuous_optimizer(
        num_initial_samples=num_initial_samples, num_optimization_runs=num_optimization_runs))


def converge_multifidelity(dev) -> int:
    """Phase 24: MUMBO × CostWeighting on Linear2Fidelity as the JAX test sets it up, held
    to its criteria; returns seed 0's kernel launches."""
    from trieste_tpu_torch import BayesianOptimizer
    from trieste_tpu_torch.data import add_fidelity_column, get_dataset_for_fidelity
    from trieste_tpu_torch.models.gp import build_multifidelity_autoregressive_models
    from trieste_tpu_torch.objectives import Linear2Fidelity, mk_observer
    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    problem = Linear2Fidelity
    space = problem.fidelity_search_space
    minimizer, minimum = float(problem.minimizers[0, 0]), float(problem.minimum[0])

    def run(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        initial = mk_observer(problem.objective)(torch.cat([
            add_fidelity_column(problem.search_space.sample(gen, 12 - 4 * f), f)
            for f in range(problem.num_fidelities)
        ]))
        model = build_multifidelity_autoregressive_models(initial, problem.num_fidelities,
                                                          problem.search_space)
        model.update(initial)
        model.optimize(initial)
        fp.launches = 0
        t0 = time.perf_counter()
        result = BayesianOptimizer(mk_observer(problem.objective), space).optimize(
            MULTIFIDELITY_STEPS, initial, model, mumbo_rule(space, gen, problem.num_fidelities, 512, 8), generator=gen,
            track_state=False,
        )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not result.is_ok:
            fail(f"phase 24: the run failed: {result.final_result.error!r}")
        final = result.try_get_final_dataset()
        top = get_dataset_for_fidelity(final, problem.num_fidelities - 1)
        qp, obs = top.astuple()
        best = int(torch.argmin(obs[:, 0]))
        x_err = abs(float(qp[best, 0]) - minimizer) / abs(minimizer)
        y_err = abs(float(obs[best, 0]) - minimum) / abs(minimum)
        ok = x_err < 0.05 and y_err <= 0.1
        fidelities = [int(f) for f in final.trimmed_query_points[len(initial):, -1].tolist()]
        print(f"phase 24 MUMBO x CostWeighting{fidelity_costs(problem.num_fidelities)} on Linear2Fidelity (fp32, "
              f"512 seeds, 8 runs), seed {seed}: {MULTIFIDELITY_STEPS} steps, query fidelities "
              f"{fidelities}, rho {[round(v, 4) for v in model.rho.tolist()]}, best top-fidelity "
              f"x {float(qp[best, 0]):.5f} (rel err {x_err:.3e}, limit 0.05), value "
              f"{float(obs[best, 0]):.5f} (rel err {y_err:.3e}, limit 0.1), "
              f"{seconds / MULTIFIDELITY_STEPS:.3f} s/step, kernel launches {fp.launches} "
              f"{'ok' if ok else 'MISSED'}")
        return ok, fp.launches

    launches = four_of_five("phase 24", run)
    print(f"phase 24 seconds: {time.perf_counter() - t_phase:.2f}")
    return launches


def multifidelity_full_width(dev, max_abs_err, N=131072, sizes=(1000, 250, 60)):
    """Phase 25: AR(1) on Linear3Fidelity at ``sizes`` points with one MUMBO ×
    CostWeighting acquire at ``N`` seeds, NARGP's propagation at 32 × ``N`` rows, and an
    encoded GPR's EGO acquire at ``N`` seeds; the kernel held against its fp64 plain version
    on each. Returns the running max abs error and the launches of the multifidelity and
    the encoded parts."""
    from trieste_tpu_torch import Dataset
    from trieste_tpu_torch.acquisition import EfficientGlobalOptimization, generate_continuous_optimizer
    from trieste_tpu_torch.data import add_fidelity_column, split_dataset_by_fidelity
    from trieste_tpu_torch.models.encoders import EncodedTrainableProbabilisticModel, encode_dataset
    from trieste_tpu_torch.models.gp import (
        MultifidelityNonlinearAutoregressive,
        build_gpr,
        build_multifidelity_autoregressive_models,
    )
    from trieste_tpu_torch.objectives import Linear3Fidelity, mk_observer
    from trieste_tpu_torch.ops import fused_predict as fp
    from trieste_tpu_torch.space import Box, one_hot_encoded_space

    t_phase = time.perf_counter()
    problem = Linear3Fidelity
    space = problem.fidelity_search_space
    gen = torch.Generator(device=dev).manual_seed(25)

    def part(label, fn, reckoned):
        torch.cuda.reset_peak_memory_stats()
        out, seconds = timed(fn)
        print(f"phase 25 {label}: {seconds:.3f} s, reckoned peak {reckoned / 1e9:.3f} GB, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        return out

    # -- AR(1) ------------------------------------------------------------------------
    data = nested_fidelity_design(problem, sizes, gen)
    model = build_multifidelity_autoregressive_models(data, 3, problem.search_space,
                                                      likelihood_variance=None)
    part(f"AR(1) on Linear3Fidelity, {'/'.join(map(str, sizes))} points: fit",
         lambda: model.optimize(data), 10 * 6 * 1024 * 1024 * 4)
    capacities = [m.dataset.capacity for m in model._models]
    expected = [Dataset.from_arrays(*(t[:n] for t in data.astuple())).capacity for n in sizes]
    if capacities != expected:
        fail(f"phase 25: expected AR(1) levels at capacities {expected}, got {capacities}")
    pool = problem.search_space.sample(gen, N)
    # a residual level of the linear problems is linear in x: its fit climbs a ridge to a
    # large variance, and the fused gate (noise/signal >= 1e-5) may keep it on the exact path
    fused = [level for level, m in enumerate(model._models)
             if fp.can_fuse(m.params, m.posterior_cache, pool)]
    ratios = [float(m.params.noise_variance / m.params.kernel.variance) for m in model._models]
    print(f"phase 25 AR(1) levels at capacities {capacities}, rho "
          f"{[round(v, 4) for v in model.rho.tolist()]}, kernel variance "
          f"{[round(float(m.params.kernel.variance), 3) for m in model._models]}, lengthscale "
          f"{[round(float(m.params.kernel.lengthscales[0]), 4) for m in model._models]}, "
          f"noise/signal {[f'{r:.3e}' for r in ratios]}: the fused gate (1e-5) admits levels {fused}")
    if 0 not in fused or len(fused) < 2:
        fail(f"phase 25: the fused gate admits AR(1) levels {fused} only")
    fp.launches = 0
    # the seed pool and each level's mean and variance, three times; a level the gate keeps
    # off also holds its cross-covariance [N, C] and the solve's result
    exact = sum(capacities[level] for level in range(3) if level not in fused)
    point = part(f"MUMBO x CostWeighting acquire at {N} seeds and 60 runs",
                 lambda: mumbo_rule(space, gen, 3, N, 60).acquire_single(space, model, data, generator=gen),
                 2 * N * 2 * 4 + 3 * 3 * 2 * N * 4 + 2 * N * exact * 4)
    mf_launches = fp.launches
    print(f"phase 25 AR(1) pool score: kernel launches {mf_launches} (predict, covariance with "
          f"the top fidelity and the top-fidelity view, each over levels {fused})")
    if point.shape != (1, 2) or not bool(space.contains(point).all()):
        fail(f"phase 25: expected one point in the fidelity space, got {point.tolist()}")
    if mf_launches != 3 * len(fused):
        fail(f"phase 25: expected 3 launches per admitted AR(1) level, got {mf_launches}")
    for level in fused:
        max_abs_err = max(max_abs_err, hold_kernel_on_pool(
            f"phase 25 AR(1) level {level} pool", model._models[level], pool, fp32_floor=True))

    # -- NARGP --------------------------------------------------------------------------
    per_level = split_dataset_by_fidelity(data, 3)
    lo, hi = per_level[0], per_level[1]
    hi_aug = Dataset.from_arrays(torch.cat([hi.trimmed_query_points,
                                             torch.zeros_like(hi.trimmed_query_points)], -1),
                                  hi.trimmed_observations)
    nargp = MultifidelityNonlinearAutoregressive(
        [build_gpr(lo, problem.search_space),
         build_gpr(hi_aug, Box([0.0, -25.0], [1.0, 25.0], device=dev))],
        generator=torch.Generator(device=dev).manual_seed(25),
    )
    two = Dataset.from_arrays(*(t[: sizes[0] + sizes[1]] for t in data.astuple()))
    part("NARGP on the first two fidelities: fit", lambda: nargp.optimize(two),
         10 * 6 * 1024 * 1024 * 4)
    upper, rows = nargp._models[1], []
    predict = upper.predict
    upper.predict = lambda x: (rows.append(x), predict(x))[1]
    query = add_fidelity_column(problem.search_space.sample(gen, N), 1)
    fp.launches = 0
    mean, var = part(f"NARGP predict at {N} rows ({nargp._num_mc} samples each)",
                     lambda: nargp.predict(query), 4 * nargp._num_mc * N * 3 * 4)
    del upper.predict
    nargp_launches = fp.launches
    print(f"phase 25 NARGP: the upper level predicted {[tuple(r.shape) for r in rows]} rows; kernel "
          f"launches {nargp_launches} (level 0's {N} rows and the upper level's "
          f"{nargp._num_mc * N})")
    if not (bool(torch.isfinite(mean).all()) and bool((var > 0).all())):
        fail("phase 25: NARGP's prediction is not finite")
    if nargp_launches != 2 or len(rows) != 1:
        fail(f"phase 25: expected one launch for the upper NARGP level, got {nargp_launches} "
             f"launches over {len(rows)} calls")
    max_abs_err = max(max_abs_err, hold_kernel_on_pool("phase 25 NARGP upper level", upper, rows[0],
                                                       fp32_floor=True))

    # -- the encoded GPR ---------------------------------------------------------------------
    encoded_space, objective = encoded_hartmann(dev)
    encoder = encoded_space.one_hot_encoder()
    raw = mk_observer(objective)(encoded_space.sample(gen, sizes[0]))
    encoded = EncodedTrainableProbabilisticModel(
        build_gpr(encode_dataset(raw, encoder), one_hot_encoded_space(encoded_space)), encoder)
    part(f"encoded GPR (Hartmann6 with 2 categorical dimensions one-hot, D 12), {sizes[0]} points: fit",
         lambda: encoded.optimize(raw), 10 * 6 * 1024 * 1024 * 4)
    fp.launches = 0
    ego = EfficientGlobalOptimization(optimizer=generate_continuous_optimizer(num_initial_samples=N))
    point = part(f"encoded GPR EI acquire at {N} seeds", lambda: ego.acquire_single(
        encoded_space, encoded, raw, generator=gen), 2 * N * 12 * 4 + N * 6 * 4)
    encoded_launches = fp.launches
    print(f"phase 25 encoded GPR: capacity {encoded.wrapped_model.dataset.capacity}, kernel "
          f"launches {encoded_launches}")
    if point.shape != (1, 6) or not bool(encoded_space.contains(point).all()):
        fail(f"phase 25: expected one point of the mixed space, got {point.tolist()}")
    if encoded_launches != 1:
        fail(f"phase 25: expected one launch over the encoded pool, got {encoded_launches}")
    max_abs_err = max(max_abs_err, hold_kernel_on_pool(
        "phase 25 encoded GPR pool", encoded.wrapped_model, encoder(encoded_space.sample(gen, N)),
        fp32_floor=True))
    print(f"phase 25 seconds: {time.perf_counter() - t_phase:.2f}")
    return max_abs_err, mf_launches + nargp_launches, encoded_launches


def encoded_hartmann(dev):
    """Hartmann6 whose first two coordinates take 4 levels each, category ``c`` at
    ``(c + 0.5) / 4``: a ``CategoricalSearchSpace([4, 4])`` × a unit box of 4 dimensions,
    one-hot encoded to 12 dimensions."""
    from trieste_tpu_torch.objectives import Hartmann6
    from trieste_tpu_torch.space import Box, CategoricalSearchSpace

    space = CategoricalSearchSpace([4, 4], device=dev) * Box([0.0] * 4, [1.0] * 4, device=dev)

    def objective(x):
        return Hartmann6.objective(torch.cat([(x[..., :2] + 0.5) / 4.0, x[..., 2:]], -1))

    return space, objective


def timed_fits(model):
    """Wrap ``model.optimize`` so that each fit's seconds and result are kept; returns the
    list they go to."""
    fits = []
    fit = model.optimize

    def timed_fit(dataset):
        result, seconds = timed(lambda: fit(dataset))
        fits.append((seconds, result))
        return result

    model.optimize = timed_fit
    return fits


def converge_gpr_mcmc(dev) -> int:
    """Phase 26: the fully-Bayesian GP to the minimum of ScaledBranin as the JAX package's
    integration test sets it up; returns seed 0's kernel launches (none is expected: the
    mixture never takes the fused path)."""
    from trieste_tpu_torch import BayesianOptimizer, stop_at_minimum
    from trieste_tpu_torch.acquisition import (
        EfficientGlobalOptimization,
        MonteCarloExpectedImprovement,
    )
    from trieste_tpu_torch.models.gp import build_gpr_mcmc
    from trieste_tpu_torch.objectives import ScaledBranin, mk_observer
    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    space = ScaledBranin.search_space.to(dev)
    observer = mk_observer(ScaledBranin.objective)
    minimum = float(ScaledBranin.minimum[0])

    def run(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        initial = observer(space.sample(gen, 6))
        model = build_gpr_mcmc(initial, space, optimize_generator=torch.Generator(device=dev).manual_seed(seed),
                               **GPR_MCMC_CONFIG)
        fits = timed_fits(model)
        fp.launches = 0
        t0 = time.perf_counter()
        result = BayesianOptimizer(observer, space).optimize(
            GPR_MCMC_STEPS, initial, model,
            EfficientGlobalOptimization(MonteCarloExpectedImprovement(GPR_MCMC_MC_SAMPLES)),
            generator=gen, track_state=False,
            early_stop_callback=stop_at_minimum(ScaledBranin.minimum, minimum_rtol=SCALED_BRANIN_RTOL))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not result.is_ok:
            fail(f"phase 26: the run failed: {result.final_result.error!r}")
        final = result.try_get_final_dataset()
        steps = len(final) - 6
        best = float(final.trimmed_observations.min())
        rel = relative_error(best, minimum)
        ok = rel <= SCALED_BRANIN_RTOL
        fit_seconds = [s for s, _ in fits]
        per_fit = ", ".join(
            f"{float(r.accept_rate.mean()):.2f}/{float(r.step_size.min()):.3g}-"
            f"{float(r.step_size.max()):.3g}/{int(r.num_nonfinite.sum())}" for _, r in fits)
        print(f"phase 26 GPR-MCMC on ScaledBranin (fp32), seed {seed}: {steps} steps of "
              f"{GPR_MCMC_STEPS}, best {best:.6f}, rel err {rel:.3e} (limit {SCALED_BRANIN_RTOL}), "
              f"{seconds / max(steps, 1):.3f} s/step: HMC fit {statistics.mean(fit_seconds):.3f} s "
              f"per fit ({len(fits)} fits), acquire and observe "
              f"{(seconds - sum(fit_seconds)) / max(steps, 1):.3f} s per step; kernel launches "
              f"{fp.launches} {'ok' if ok else 'MISSED'}")
        print(f"phase 26 seed {seed} fits (mean accept rate/step sizes min-max/non-finite "
              f"log-posterior evaluations): {per_fit}")
        if fp.launches:
            fail(f"phase 26: the GPR-MCMC run launched the fused kernel {fp.launches} times")
        return ok, fp.launches

    launches = four_of_five("phase 26 GPR-MCMC", run)
    # the seed pool's MC EI samples, improvements and mask [5000, 500], and six [S, 5000, 32]
    # tensors of its mixture prediction at the run's largest capacity
    reckoned = 3 * 5000 * GPR_MCMC_MC_SAMPLES * 4 + 6 * GPR_MCMC_CONFIG["num_retained"] * 5000 * 32 * 4
    memory_line("phase 26", reckoned, t_phase)
    return launches


def gpr_mcmc_full_width(model_gpr, data, space, dev, N=131072) -> int:
    """Phase 27: the fully-Bayesian GP on phase 5's Hartmann6 data (capacity 1024) at its
    builder's defaults: one HMC fit, the mixture's prediction at ``N`` pool rows against
    the fp64 plain mixture on the same stack, and one MC EI acquire at ``N`` seeds; returns
    the kernel launches (none is expected)."""
    from trieste_tpu_torch.acquisition import (
        EfficientGlobalOptimization,
        MonteCarloExpectedImprovement,
        generate_continuous_optimizer,
    )
    from trieste_tpu_torch.models.gp import build_gpr_mcmc
    from trieste_tpu_torch.models.gp import mcmc
    from trieste_tpu_torch.models.gp.posterior import build_cache, predict_f_reference
    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    fp.launches = 0
    model = build_gpr_mcmc(data, space, optimize_generator=torch.Generator(device=dev).manual_seed(2))
    result, fit_seconds = timed(lambda: model.optimize(data))
    print(f"phase 27 GPR-MCMC fit (Hartmann6, {len(data)} points, capacity {data.capacity}, "
          f"{result.samples.shape[0]} chains x {result.samples.shape[1]} samples after "
          f"{model._num_warmup} warmup, {model.num_hyper_samples} retained, fp32): "
          f"{fit_seconds:.2f} s; accept rate per chain {[round(v, 3) for v in result.accept_rate.tolist()]}, "
          f"step sizes {[round(v, 4) for v in result.step_size.tolist()]}, non-finite log-posterior "
          f"evaluations {result.num_nonfinite.tolist()}")
    gen = torch.Generator(device=dev).manual_seed(3)
    pool = space.sample(gen, N)
    stack, X, Y, mask = model.params_stack, data.query_points, data.observations, data.mask
    with torch.no_grad():
        (mean, var), predict_seconds = timed(lambda: model.predict(pool))
        kernel = stack.kernel.replace(variance=stack.kernel.variance.double(),
                                      lengthscales=stack.kernel.lengthscales.double())
        stack64 = stack.replace(kernel=kernel, noise_variance=stack.noise_variance.double(),
                                mean_constant=stack.mean_constant.double())
        caches = model.posterior_caches
        same = caches.replace(X=caches.X.double(), L=caches.L.double(), alpha=caches.alpha.double())
        em, ev, rm, rv, ok = compare((mean, var), mcmc._mixture_predict(stack64, same, pool.double()))
        caches64 = build_cache(stack64, X.double(), Y.double(), mask, with_linvt=False)
        fem, fev, _, _, _ = compare((mean, var), mcmc._mixture_predict(stack64, caches64, pool.double()))
        gpr64 = fp64_state(model_gpr.params, model_gpr.dataset)
        exact = predict_f_reference(model_gpr.params, model_gpr.posterior_cache, pool)
        gem, gev, _, _, _ = compare(exact, predict_f_reference(*gpr64, pool.double()))
    print(f"phase 27 mixture of {model.num_hyper_samples} samples at {N} pool rows (fp32, "
          f"{predict_seconds:.3f} s) vs the fp64 plain mixture on the same stack and factors: "
          f"mean abs {em:.3e} rel {rm:.3e}, var abs {ev:.3e} rel {rv:.3e}, tolerance mean rtol "
          f"{MEAN_RTOL} atol {MEAN_ATOL}, var rtol {VAR_RTOL} atol {VAR_ATOL} "
          f"{'ok' if ok else 'OUT OF TOLERANCE'}; against fp64 factors of the same stack (the fp32 "
          f"Cholesky's error included) mean abs {fem:.3e}, var abs {fev:.3e}, beside phase 5's GP "
          f"by the same exact path: mean abs {gem:.3e}, var abs {gev:.3e}")
    if not ok:
        fail("phase 27: the fp32 mixture disagrees with its fp64 plain version")
    chunk = max(1, min(model.num_hyper_samples, mcmc.MIXTURE_CHUNK_BYTES // (N * data.capacity * 4)))
    chunk_bytes = chunk * N * data.capacity * 4
    # the Gram's temporaries (r², r, z and the Matérn polynomial) at most five chunks at a
    # time, the triangular solve's input and output one more each; the MC samples [N, S]
    reckoned = 7 * chunk_bytes + 3 * N * GPR_MCMC_MC_SAMPLES * 4
    del same, caches64, stack64, exact, gpr64, mean, var
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rule = EfficientGlobalOptimization(
        MonteCarloExpectedImprovement(GPR_MCMC_MC_SAMPLES),
        optimizer=generate_continuous_optimizer(num_initial_samples=N),
    )
    point, acquire_seconds = timed(lambda: rule.acquire_single(space, model, data, generator=gen))
    peak = torch.cuda.max_memory_allocated() - base
    print(f"phase 27 MC EI ({GPR_MCMC_MC_SAMPLES} samples) acquire at {N} seeds: "
          f"{acquire_seconds:.2f} s, point {[round(v, 4) for v in point[0].tolist()]}; peak "
          f"{peak / 1e9:.3f} GB above the model against {reckoned / 1e9:.3f} GB reckoned "
          f"({chunk} samples a chunk of {chunk_bytes / 1e9:.3f} GB; the JAX mixture's vmap forms "
          f"two [{model.num_hyper_samples}, {N}, {data.capacity}] tensors, "
          f"{2 * model.num_hyper_samples * N * data.capacity * 4 / 1e9:.1f} GB); kernel launches "
          f"{fp.launches}")
    if not (bool(torch.isfinite(point).all()) and bool(space.contains(point).all())):
        fail("phase 27: the acquired point is not finite or not in the box")
    if fp.launches:
        fail(f"phase 27: the GPR-MCMC paths launched the fused kernel {fp.launches} times")
    memory_line("phase 27", reckoned, t_phase)
    return fp.launches


def summaries_profiling_objectives(dev) -> int:
    """Phase 28: a three-step quickstart with a JSON-lines writer, held to the JAX loop's
    summary names and to one device-to-host transfer per flush; a profiler trace of one
    more step; the new objectives on the card. Returns the quickstart's kernel launches."""
    import tempfile
    import warnings

    from trieste_tpu_torch import BayesianOptimizer, logging, profiling
    from trieste_tpu_torch import bayesian_optimizer as loop
    from trieste_tpu_torch import objectives
    from trieste_tpu_torch.models.gp import build_gpr
    from trieste_tpu_torch.objectives import ScaledBranin, mk_observer
    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    space = ScaledBranin.search_space.to(dev)
    observer = mk_observer(ScaledBranin.objective)
    gen = torch.Generator(device=dev).manual_seed(QUICKSTART_SEED)
    initial = observer(space.sample(gen, 5))
    model = build_gpr(initial, space)
    flushes = []
    flush = loop.flush_deferred_summaries

    def counted_flush(force=False):
        """The loop's flush with the synchronizing calls it makes counted."""
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                flush(force)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            seconds = time.perf_counter() - t0
        flushes.append((sum("called a synchronizing CUDA operation" in str(w.message) for w in caught),
                        seconds))

    loop.flush_deferred_summaries = counted_flush
    try:
        with tempfile.TemporaryDirectory() as logdir:
            writer = logging.JsonlSummaryWriter(logdir)
            fp.launches = 0
            with logging.tensorboard_writer(writer), logging.step_number(0):
                result = BayesianOptimizer(observer, space).optimize(
                    3, initial, model, generator=gen, track_state=False)
            writer.close()
            launches = fp.launches
            with open(Path(logdir) / "events.jsonl") as f:
                events = [json.loads(line) for line in f]
            if not result.is_ok:
                fail(f"phase 28: the quickstart failed: {result.final_result.error!r}")
            t0 = time.perf_counter()
            with profiling.trace(str(Path(logdir) / "trace")):
                traced = BayesianOptimizer(observer, space).optimize(
                    1, result.try_get_final_dataset(), model, generator=gen, track_state=False,
                    fit_initial_model=False)
                torch.cuda.synchronize()
            trace_seconds = time.perf_counter() - t0
            (trace_path,) = (Path(logdir) / "trace").iterdir()
            trace_bytes = trace_path.stat().st_size
            trace = json.loads(trace_path.read_text())
    finally:
        loop.flush_deferred_summaries = flush
    by_step = {}
    for event in events:
        by_step.setdefault(event["step"], []).append(event["tag"])
    want = {0: sorted(QUICKSTART_SUMMARIES_AT_STEP_0),
            **{step: sorted(QUICKSTART_SUMMARIES_PER_STEP) for step in (1, 2, 3)}}
    got = {step: sorted(names) for step, names in by_step.items()}
    print(f"phase 28 quickstart with a JSON-lines writer (3 steps): {len(events)} events, "
          f"{ {step: len(names) for step, names in sorted(got.items())} } by step; the JAX "
          f"loop's names at every step: {got == want}; flushes (synchronizing calls, s): "
          f"{[(n, round(sec, 5)) for n, sec in flushes]}; kernel launches {launches}")
    if got != want:
        fail(f"phase 28: the summary names differ from the JAX loop's: got {got}, want {want}")
    if [n for n, _ in flushes] != [1, 1, 1]:
        fail(f"phase 28: a flush did not make exactly one device-to-host transfer: {flushes}")
    if not traced.is_ok:
        fail(f"phase 28: the traced step failed: {traced.final_result.error!r}")
    kernels = {}
    for event in trace["traceEvents"]:
        if event.get("cat") == "kernel":
            kernels[event["name"]] = kernels.get(event["name"], 0) + 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:3]
    print(f"phase 28 profiler trace of one more step ({trace_seconds:.2f} s with the export, "
          f"{trace_bytes / 1e6:.1f} MB, {len(trace['traceEvents'])} events): "
          f"{sum(kernels.values())} CUDA kernel events of "
          f"{len(kernels)} kernels, most launched {[(name[:60], n) for name, n in top]}")
    if not kernels:
        fail("phase 28: the profiler trace names no CUDA kernel")
    worst = 0.0
    for name in NEW_OBJECTIVES:
        problem = getattr(objectives, name)
        on_card = problem.objective(torch.as_tensor(problem.minimizers, dtype=torch.float32, device=dev))
        plain = problem.objective(torch.as_tensor(problem.minimizers, dtype=torch.float64))
        err = float((on_card.cpu().double() - plain).abs().max())
        limit = OBJECTIVE_FP32_RTOL * max(1.0, float(plain.abs().max()))
        worst = max(worst, err / limit)
        if err > limit:
            fail(f"phase 28: {name} on the card is {err:.3e} from its fp64 value (limit {limit:.3e})")
    print(f"phase 28 objectives at their minimizers on the card (fp32) vs fp64 on the CPU: "
          f"{len(NEW_OBJECTIVES)} of {len(NEW_OBJECTIVES)} within {OBJECTIVE_FP32_RTOL}·max(1, |f|), "
          f"worst at {worst:.3f} of its limit")
    print(f"phase 28 seconds: {time.perf_counter() - t_phase:.2f}")
    return launches


def deep_model_builders():
    """Phase 29's models as the JAX package's integration test builds them
    (``tests/integration/test_model_bayesian_optimization.py:48-53``), each with its step
    budget: ``(budget, build(initial, space, generator))``."""
    from trieste_tpu_torch.models.deepgp import build_vanilla_deep_gp
    from trieste_tpu_torch.models.ensembles import build_deep_ensemble

    return {
        "DGP": (DEEP_GP_STEPS, lambda data, space, gen: build_vanilla_deep_gp(
            data, space, num_layers=2, num_train_steps=800, generator=gen)),
        "deep ensemble": (DEEP_ENSEMBLE_STEPS, lambda data, space, gen: build_deep_ensemble(
            data, ensemble_size=5, num_train_steps=600, generator=gen)),
    }


def converge_deep_models(dev) -> int:
    """Phase 29: the deep GP and the deep ensemble to the minimum of ScaledBranin with PCTS
    over 4 points, as the JAX package's integration test sets them up; returns seed 0's
    kernel launches over both (none is expected: neither model predicts by the exact GP)."""
    from trieste_tpu_torch import BayesianOptimizer, stop_at_minimum
    from trieste_tpu_torch.acquisition import (
        EfficientGlobalOptimization,
        ParallelContinuousThompsonSampling,
    )
    from trieste_tpu_torch.objectives import ScaledBranin, mk_observer
    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    space = ScaledBranin.search_space.to(dev)
    observer = mk_observer(ScaledBranin.objective)
    minimum = float(ScaledBranin.minimum[0])
    launches = 0
    for name, (budget, build) in deep_model_builders().items():
        def run(seed):
            gen = torch.Generator(device=dev).manual_seed(seed)
            initial = observer(space.sample(gen, 6))
            model = build(initial, space, torch.Generator(device=dev).manual_seed(seed))
            fits = timed_fits(model)
            rule = EfficientGlobalOptimization(ParallelContinuousThompsonSampling(),
                                               num_query_points=4)
            fp.launches = 0
            t0 = time.perf_counter()
            result = BayesianOptimizer(observer, space).optimize(
                budget, initial, model, rule, generator=gen, track_state=False,
                early_stop_callback=stop_at_minimum(ScaledBranin.minimum,
                                                    minimum_rtol=DEEP_MODEL_RTOL))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if not result.is_ok:
                fail(f"phase 29 {name}: the run failed: {result.final_result.error!r}")
            final = result.try_get_final_dataset()
            steps = (len(final) - 6) // 4
            best = float(final.trimmed_observations.min())
            rel = relative_error(best, minimum)
            ok = rel <= DEEP_MODEL_RTOL
            fit_seconds = sum(s for s, _ in fits)
            nonfinite = sum(int(r.num_nonfinite) for _, r in fits)
            print(f"phase 29 {name} with PCTS over 4 points on ScaledBranin (fp32), seed {seed}: "
                  f"{steps} steps of {budget}, best {best:.6f}, rel err {rel:.3e} (limit "
                  f"{DEEP_MODEL_RTOL}), {seconds / max(steps, 1):.3f} s/step: fit "
                  f"{fit_seconds / len(fits):.3f} s per fit ({len(fits)} fits, "
                  f"{fit_seconds / len(fits) / model._num_train_steps * 1e3:.3f} ms per Adam step), "
                  f"acquire and observe {(seconds - fit_seconds) / max(steps, 1):.3f} s per step; "
                  f"final training loss {float(fits[-1][1].loss):.4f}, non-finite losses "
                  f"{nonfinite}; kernel launches {fp.launches} {'ok' if ok else 'MISSED'}")
            if fp.launches:
                fail(f"phase 29 {name}: the run launched the fused kernel {fp.launches} times")
            return ok, fp.launches

        launches += four_of_five(f"phase 29 {name}", run)
    # a PCTS pool of 5000 seeds x 4 columns through the deep GP's two layers (two columns a
    # chunk at most: Kux, A and SA of 40 inducing points), and the Adam noise of one fit
    reckoned = 4 * 5000 * (2 + 2) * 40 * 4 + 800 * 8 * 64 * 3 * 4
    memory_line("phase 29", reckoned, t_phase)
    return launches


def deep_models_full_width(data, space, dev, N=131072) -> int:
    """Phase 30: the deep GP and the deep ensemble at their builders' defaults on phase 5's
    Hartmann6 data (capacity 1024): one fit, one prediction at ``N`` rows and one PCTS
    acquire of 4 points at ``N`` seeds each; the experimental plotting imported. Returns the
    kernel launches (none is expected)."""
    from trieste_tpu_torch.acquisition import (
        EfficientGlobalOptimization,
        ParallelContinuousThompsonSampling,
        generate_continuous_optimizer,
    )
    from trieste_tpu_torch.models.deepgp import build_vanilla_deep_gp, deep_gp
    from trieste_tpu_torch.models.ensembles import build_deep_ensemble
    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    fp.launches = 0
    C, D, V = data.capacity, data.dimension, 4
    gen = torch.Generator(device=dev).manual_seed(30)
    pool = space.sample(gen, N)
    models = {
        "DGP": build_vanilla_deep_gp(data, space, generator=torch.Generator(device=dev).manual_seed(2)),
        "deep ensemble": build_deep_ensemble(data, generator=torch.Generator(device=dev).manual_seed(2)),
    }
    worst = 0.0
    for name, model in models.items():
        if name == "DGP":
            p = model.params
            M, W, S = p.layers[0].inducing_points.shape[0], p.noise_width, model._num_predict_samples
            steps = model._num_train_steps
            block = max(1, min(steps, deep_gp.FIT_NOISE_BLOCK_BYTES // (8 * C * W * 4)))
            fit_bytes = (block + 1) * 8 * C * W * 4
            fit_what = f"a block of {block} steps' noise and the step's buffer"
            chunk = deep_gp._sample_chunk(p, S, N, 4)
            # the noise of the paths, one chunk's Kux, A and SA, the paths (and their moments)
            predict_bytes = S * N * W * 4 + chunk * (max(l.q_mu.shape[-1] for l in p.layers) + 2) * M * N * 4 + 2 * S * N * 4
            acquire_bytes = N * V * D * 4 * 2 + V * N * W * 4 + min(V, deep_gp._sample_chunk(p, V, N, 4)) * 8 * M * N * 4
            detail = (f"2 layers, M = {M}, width {p.layers[0].q_mu.shape[-1]}, {steps} Adam steps of 8 "
                      f"paths, {S} predict samples ({chunk} a chunk)")
        else:
            E, H = model.ensemble_size, max(model.params.member_params.hidden_units)
            steps = model._num_train_steps
            fit_bytes, fit_what = E * C * (8 + 4), "the bootstrap's indices and weights"
            predict_bytes = 4 * E * N * H * 4  # two hidden activations with their ReLU inputs
            acquire_bytes = N * V * D * 4 * 2 + 4 * V * N * H * 4
            detail = (f"E = {E}, hidden {model.params.member_params.hidden_units}, {steps} Adam "
                      f"steps, bootstrap")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        result, fit_seconds = timed(lambda: model.optimize(data))
        fit_peak = torch.cuda.max_memory_allocated() - base
        print(f"phase 30 {name} on Hartmann6 ({len(data)} points, capacity {C}, fp32; {detail}): "
              f"fit {fit_seconds:.3f} s ({fit_seconds / steps * 1e3:.3f} ms per Adam step), final "
              f"loss {float(result.loss):.4f}, non-finite losses {int(result.num_nonfinite)}; peak "
              f"{fit_peak / 1e9:.3f} GB, of which {fit_what} {fit_bytes / 1e9:.3f} GB (the rest, "
              f"the step's graph and the libraries' workspaces, is not reckoned)")
        if not bool(torch.isfinite(result.loss)):
            fail(f"phase 30 {name}: the fit ended at a non-finite loss")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            (mean, var), predict_seconds = timed(lambda: model.predict(pool))
        predict_peak = torch.cuda.max_memory_allocated() - base
        if not (mean.shape == var.shape == (N, 1) and bool(torch.isfinite(mean).all())
                and bool((var > 0).all())):
            fail(f"phase 30 {name}: the prediction at {N} rows is not finite and positive")
        del mean, var
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rule = EfficientGlobalOptimization(
            ParallelContinuousThompsonSampling(),
            optimizer=generate_continuous_optimizer(num_initial_samples=N), num_query_points=V,
        )
        points, acquire_seconds = timed(lambda: rule.acquire_single(space, model, data, generator=gen))
        acquire_peak = torch.cuda.max_memory_allocated() - base
        print(f"phase 30 {name}: predict at {N} rows {predict_seconds:.3f} s, peak "
              f"{predict_peak / 1e9:.3f} GB against {predict_bytes / 1e9:.3f} GB reckoned; PCTS "
              f"acquire of {V} points at {N} seeds and {10 * D} runs {acquire_seconds:.3f} s, peak "
              f"{acquire_peak / 1e9:.3f} GB against {acquire_bytes / 1e9:.3f} GB reckoned; kernel "
              f"launches so far {fp.launches}")
        if points.shape != (V, D) or not bool(space.contains(points).all()):
            fail(f"phase 30 {name}: expected {V} points in the box, got {tuple(points.shape)}")
        worst = max(worst, predict_peak / predict_bytes, acquire_peak / acquire_bytes)
    if fp.launches:
        fail(f"phase 30: a deep model reached the exact GP's kernel ({fp.launches} launches)")
    import importlib.util

    import trieste_tpu_torch.experimental.plotting as plotting

    print(f"phase 30 trieste_tpu_torch.experimental.plotting imported ({len(plotting.__all__)} "
          f"names); matplotlib found: {importlib.util.find_spec('matplotlib') is not None}, plotly "
          f"found: {plotting.PLOTLY_AVAILABLE}")
    print(f"phase 30 largest peak over its reckoning: {worst:.3f}")
    print(f"phase 30 seconds: {time.perf_counter() - t_phase:.2f}")
    return fp.launches


def counting_collectives():
    """Wrap ``torch.distributed``'s collectives to count their calls: ``(count, restore)``."""
    import torch.distributed as dist

    count = {"n": 0}
    originals = {name: getattr(dist, name) for name in COLLECTIVES if hasattr(dist, name)}

    def counted(fn):
        def call(*args, **kwargs):
            count["n"] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in originals.items():
        setattr(dist, name, counted(fn))

    def restore():
        for name, fn in originals.items():
            setattr(dist, name, fn)

    return count, restore


def ei_acquire(model, data, space, dev, num_seeds):
    """One EI acquire at ``num_seeds`` seeds and the default 60 runs, from a generator
    seeded ``MULTI_DEVICE_SEED``: ``(point, kernel launches, seconds)``."""
    from trieste_tpu_torch.acquisition import (
        EfficientGlobalOptimization, generate_continuous_optimizer,
    )
    from trieste_tpu_torch.ops import fused_predict as fp

    rule = EfficientGlobalOptimization(
        optimizer=generate_continuous_optimizer(num_initial_samples=num_seeds)
    )
    generator = torch.Generator(device=dev).manual_seed(MULTI_DEVICE_SEED)
    torch.cuda.synchronize()
    fp.launches = 0
    t0 = time.perf_counter()
    point = rule.acquire_single(space, model, data, generator=generator)
    torch.cuda.synchronize()
    return point, fp.launches, time.perf_counter() - t0


def multi_device_fit(data, space, dev, pool_sharding=None, blocks=1):
    """Phase 31(b)'s fit: ``fit_gpr``'s restarts from ``build_gpr``'s start on ``data``,
    ``MULTI_DEVICE_FIT_STARTS`` of them drawn from a generator seeded
    ``MULTI_DEVICE_SEED``, sharded by ``pool_sharding``, or unsharded in one call or in
    ``blocks`` calls of the ranks' blocks, the best kept (ties to the first):
    ``(loss, packed parameters, seconds)``."""
    from trieste_tpu_torch.models.gp import build_gpr
    from trieste_tpu_torch.models.gp.training import (
        fit_gpr_from_starts, pack_params, randomize_starts,
    )

    template = build_gpr(data, space)
    generator = torch.Generator(device=dev).manual_seed(MULTI_DEVICE_SEED)
    starts = randomize_starts(generator, template.params, MULTI_DEVICE_FIT_STARTS,
                              template._train_noise, priors=template._priors)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [fit_gpr_from_starts(
        block, template.params, data.query_points, data.observations, data.mask,
        train_noise=template._train_noise, max_iters=template._max_optimize_iters,
        priors=template._priors, pool_sharding=pool_sharding,
    ) for block in starts.chunk(blocks)]
    torch.cuda.synchronize()
    best = min(results, key=lambda r: float(r.loss))
    return float(best.loss), pack_params(best.params).tolist(), time.perf_counter() - t0


def multi_device_rank(rank: int, world: int, coordinator: str, workdir: str) -> int:
    """One of phase 31(b)'s ranks: join the gloo group on ``cuda:0``, fit, acquire and
    score the gate's pool under the mesh of every rank; write what it saw to
    ``workdir/rank{rank}.json``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.distributed as dist

    from trieste_tpu_torch.models.gp import GaussianProcessRegression
    from trieste_tpu_torch.objectives import Hartmann6
    from trieste_tpu_torch.ops import fused_predict as fp
    from trieste_tpu_torch.parallel import (
        collectives, create_multi_host_mesh, global_mesh, initialize_multi_host, pool_sharding,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # NCCL refuses two ranks on one GPU, so the ranks that share the card join by gloo,
    # which takes host copies of the small operands that cross ranks
    initialize_multi_host(coordinator, world, rank, backend="gloo", device=dev)
    try:
        mesh = create_multi_host_mesh()
        saved = torch.load(Path(workdir) / "phase5.pt", map_location=dev, weights_only=False)
        data, space = saved["data"], Hartmann6.search_space
        loss, packed, fit_s = multi_device_fit(data, space, dev, pool_sharding(mesh))

        calls = []
        launch = fp.launch

        def recorded(*args):
            out = launch(*args)
            calls.append((args, out))
            return out

        fp.launch = recorded
        model = GaussianProcessRegression(saved["params"], data)
        with global_mesh(mesh):
            point, launches, acquire_s = ei_acquire(model, data, space, dev, 131072)
            gate_point, gate_launches, _ = ei_acquire(model, data, space, dev,
                                                      MULTI_DEVICE_GATE_POOL)
        fp.launch = launch
        errors, rows = [], []
        for args, out in calls:  # the kernel on this rank's rows against its plain version
            plain = fp.fused_predict_reference(args[0], *(t.double() for t in args[1:]))
            em, ev, _, _, ok = compare(out, plain)
            errors.append((em, ev, ok))
            rows.append(args[1].shape[0])
        result = {
            "rank": rank, "mesh_size": mesh.size, "fit_loss": loss, "fit_params": packed,
            "fit_s": fit_s, "point": point.tolist(), "launches": launches,
            "acquire_s": acquire_s, "gate_point": gate_point.tolist(),
            "gate_launches": gate_launches, "kernel_rows": rows,
            "kernel_abs_err": max([max(em, ev) for em, ev, _ in errors], default=0.0),
            "kernel_ok": all(ok for _, _, ok in errors),
            "collectives": collectives.collective_calls,
            "bytes_received": collectives.bytes_received, "builds": fp.builds,
            "jax_imported": "jax" in sys.modules,
        }
    finally:
        dist.destroy_process_group()
    (Path(workdir) / f"rank{rank}.json").write_text(json.dumps(result))
    return 0


def one_rank_mesh(label, model, data, space, dev, base):
    """Phase 31(a): the acquire under a mesh of this process alone (in the process group,
    if one is initialised) equals ``base`` bit for bit, with its launches and no
    collective call; returns the launches."""
    from trieste_tpu_torch.parallel import create_mesh, global_mesh

    mesh = create_mesh()
    count, restore = counting_collectives()
    try:
        with global_mesh(mesh):
            point, launches, seconds = ei_acquire(model, data, space, dev, 131072)
    finally:
        restore()
    print(f"phase 31 {label}: mesh of {mesh.size} rank on "
          f"cuda:{torch.cuda.current_device()}, point "
          f"{point.tolist()}, kernel launches {launches}, collective calls {count['n']}, "
          f"{seconds:.3f} s")
    if mesh.size != 1 or not torch.equal(point, base[0]):
        fail(f"phase 31 {label}: the point differs from the unsharded acquire's")
    if launches != base[1] or count["n"] != 0:
        fail(f"phase 31 {label}: {launches} launches and {count['n']} collectives, "
             f"expected {base[1]} and 0")
    return launches


def multi_device(model, data, space, dev, max_abs_err):
    """Phase 31: a one-rank mesh takes the unsharded path; two ranks on the one card agree
    with the unsharded fit and acquire. Returns ``(max_abs_err, per-rank launches)``."""
    import socket
    import tempfile

    import torch.distributed as dist

    from trieste_tpu_torch.acquisition import ExpectedImprovement
    from trieste_tpu_torch.models.gp import GaussianProcessRegression

    t_phase = time.perf_counter()
    model = GaussianProcessRegression(model.params, data)
    base = ei_acquire(model, data, space, dev, 131072)
    print(f"phase 31 unsharded EI acquire on phase 5's model (capacity {data.capacity}, "
          f"{len(data)} points, 131072 seeds, 60 runs): point {base[0].tolist()}, kernel "
          f"launches {base[1]}, {base[2]:.3f} s")
    one_rank_mesh("(a) no process group", model, data, space, dev, base)
    with tempfile.TemporaryDirectory() as workdir:
        dist.init_process_group("nccl", init_method=f"file://{workdir}/nccl", world_size=1,
                                rank=0)
        try:
            one_rank_mesh("(a) one-rank NCCL group", model, data, space, dev, base)
        finally:
            dist.destroy_process_group()

        # (b) the parent's unsharded references, then two ranks on the card
        fit_loss, fit_params, fit_s = multi_device_fit(data, space, dev)
        block_loss, block_params, _ = multi_device_fit(data, space, dev,
                                                       blocks=MULTI_DEVICE_RANKS)
        gate = ei_acquire(model, data, space, dev, MULTI_DEVICE_GATE_POOL)
        print(f"phase 31 (b) unsharded: fit of {MULTI_DEVICE_FIT_STARTS} restarts loss "
              f"{fit_loss!r} in {fit_s:.3f} s, of the ranks' blocks in turn {block_loss!r}; "
              f"the {MULTI_DEVICE_GATE_POOL}-row pool's acquire launches {gate[1]}")
        torch.save({"data": data, "params": model.params}, Path(workdir) / "phase5.pt")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            coordinator = f"localhost:{sock.getsockname()[1]}"
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--multi-device-rank", str(r),
             str(MULTI_DEVICE_RANKS), coordinator, workdir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ) for r in range(MULTI_DEVICE_RANKS)]
        try:
            logs = [p.communicate(timeout=MULTI_DEVICE_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                print(log[-6000:])
                fail(f"phase 31 (b): rank {r} exited with {p.returncode}")
        ranks = [json.loads((Path(workdir) / f"rank{r}.json").read_text())
                 for r in range(MULTI_DEVICE_RANKS)]

    half = 131072 // MULTI_DEVICE_RANKS
    ei = ExpectedImprovement().prepare_acquisition_function(model, data)
    base_ei = float(ei(base[0][:, None, :]))
    for r in ranks:
        point = torch.tensor(r["point"], device=dev)
        distance = (point - base[0]).abs().max().item()
        point_ei = float(ei(point[:, None, :]))
        print(f"phase 31 (b) rank {r['rank']} of {r['mesh_size']} (gloo, cuda:0): fit "
              f"{r['fit_s']:.3f} s, loss {r['fit_loss']!r} (unsharded {fit_loss!r}), params "
              f"max abs diff {max(abs(a - b) for a, b in zip(r['fit_params'], fit_params)):.3e}; "
              f"acquire {r['acquire_s']:.3f} s, point max abs diff {distance:.3e}, EI there "
              f"{point_ei!r} (unsharded point {base_ei!r}), kernel "
              f"launches {r['launches']} over rows {r['kernel_rows']}, kernel vs plain (fp64) "
              f"max abs err {r['kernel_abs_err']:.3e}; the {MULTI_DEVICE_GATE_POOL}-row pool "
              f"launches {r['gate_launches']}; {r['collectives']} collectives, "
              f"{r['bytes_received']} bytes received; builds {r['builds']}")
        if r["builds"] != 0 or r["jax_imported"] or r["mesh_size"] != MULTI_DEVICE_RANKS:
            fail(f"phase 31 (b) rank {r['rank']}: built the kernel, imported JAX or saw a "
                 f"mesh of {r['mesh_size']}")
        if (r["fit_loss"], r["fit_params"]) != (block_loss, block_params):
            fail(f"phase 31 (b) rank {r['rank']}: the sharded fit differs from the unsharded "
                 f"fits of the ranks' blocks")
        if abs(r["fit_loss"] - fit_loss) > MULTI_DEVICE_FIT_LOSS_RTOL * abs(fit_loss):
            fail(f"phase 31 (b) rank {r['rank']}: the sharded fit's loss is off the unsharded")
        if r["launches"] != base[1] or r["kernel_rows"][:1] != [half] or not r["kernel_ok"]:
            fail(f"phase 31 (b) rank {r['rank']}: expected {base[1]} launch over {half} rows "
                 f"within the contract")
        if distance > MULTI_DEVICE_POINT_ATOL or point_ei < base_ei * (1 - MULTI_DEVICE_EI_RTOL):
            fail(f"phase 31 (b) rank {r['rank']}: the sharded point is off the unsharded one")
        if r["gate_launches"] != gate[1] or gate[1] != 1:
            fail(f"phase 31 (b) rank {r['rank']}: the {MULTI_DEVICE_GATE_POOL}-row pool "
                 f"launched {r['gate_launches']} times, unsharded {gate[1]}, expected 1")
        if r["point"] != ranks[0]["point"] or r["fit_params"] != ranks[0]["fit_params"]:
            fail("phase 31 (b): the ranks disagree")
        max_abs_err = max(max_abs_err, r["kernel_abs_err"])
    print("phase 31 (b): two ranks time-share one card, so these seconds say nothing of "
          "scaling over devices")
    print(f"phase 31 seconds: {time.perf_counter() - t_phase:.2f}")
    return max_abs_err, [r["launches"] + r["gate_launches"] for r in ranks]


def _numbers(value):
    """Every int and float in an example's returned value, through lists and dicts."""
    if isinstance(value, dict):
        return [x for v in value.values() for x in _numbers(v)]
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in _numbers(v)]
    return [value] if isinstance(value, (int, float)) else []


def example_checks(name, out):
    """What an example's returned dict must show, as ``tests/test_torch_examples.py``
    holds it on the CPU; returns the first fault, or ``None``."""
    if not _numbers(out) or not all(math.isfinite(x) for x in _numbers(out)):
        return "a returned number is not finite"
    if name == "ask_tell_optimization" and out["resumes_exactly"] is not True:
        return "the resumed optimizer asked for another point than the uninterrupted one"
    if name == "recovering_from_errors" and (out["first_run_ok"] or not out["resumed_ok"]):
        return "the first run is not an Err, or the resumed run not Ok"
    if name == "inequality_constraints" and not (
            out["explicit_feasible"] and 0.3 - 1e-5 <= sum(out["explicit_point"]) <= 1.2 + 1e-5):
        return "the explicitly constrained point is infeasible"
    if name == "multi_objective_ehvi":
        front = torch.tensor(out["front"], dtype=torch.float64)
        dominated = ((front[None] <= front[:, None]).all(-1)
                     & (front[None] < front[:, None]).any(-1)).any()
        if bool(dominated):
            return "a point of the EHVI front is dominated"
    if name == "mixed_search_spaces" and out["x2_on_grid"] is not True:
        return "the best point's discrete coordinate is off the grid"
    return None


def run_examples(max_abs_err):
    """Phase 32: every tutorial of ``examples_torch/`` in this process on ``cuda`` at its
    smallest budget, with the kernel phase 1 built; each must return what its checks
    expect and launch the kernel as ``EXAMPLE_LAUNCHES`` predicts, and the kernel is held
    against its fp64 plain version on every pool it scored. Returns ``(max_abs_err,
    launches per example)``."""
    import contextlib
    import importlib.util
    import io
    import tempfile
    import types

    import numpy as np

    from trieste_tpu_torch.ops import fused_predict as fp

    t_phase = time.perf_counter()
    directory = Path(__file__).resolve().parent / "examples_torch"
    launches = {}
    held = []
    with tempfile.TemporaryDirectory() as logs:
        tempdir, tempfile.tempdir = tempfile.tempdir, logs  # the logging example's logdir
        try:
            for name in EXAMPLES:
                spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                              directory / f"{name}.py")
                module = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(module)
                args = () if name in EXAMPLES_WITHOUT_BUDGET else (1,)
                np.random.seed(0)  # the fits' restarts, as the CPU tests pin them
                pools, printed = [], io.StringIO()
                original = recording_pools(pools)
                before = fp.launches
                try:
                    with contextlib.redirect_stdout(printed):
                        out, seconds = timed(lambda: module.main(*args, device="cuda"))
                except BaseException:
                    print(printed.getvalue()[-6000:])
                    raise
                finally:
                    fp.fused_predict_f = original
                launches[name] = fp.launches - before
                print(f"phase 32 {name}: {seconds:.2f} s, kernel launches {launches[name]} "
                      f"(predicted {EXAMPLE_LAUNCHES.get(name, 0)}), returned {json.dumps(out)}")
                fault = example_checks(name, out)
                if fault:
                    print(printed.getvalue()[-6000:])
                    fail(f"phase 32 {name}: {fault}")
                held += [(name, params, cache, flat) for params, cache, flat in pools]
        finally:
            tempfile.tempdir = tempdir
    for i, (name, params, cache, flat) in enumerate(held):
        model = types.SimpleNamespace(params=params, posterior_cache=cache)
        max_abs_err = max(max_abs_err, hold_kernel_on_pool(f"phase 32 {name} pool {i}",
                                                           model, flat))
    predicted = {name: EXAMPLE_LAUNCHES.get(name, 0) for name in EXAMPLES}
    if launches != predicted:
        fail(f"phase 32: kernel launches {launches}, predicted {predicted}")
    print(f"phase 32 seconds: {time.perf_counter() - t_phase:.2f}")
    return max_abs_err, launches


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

        def add_histogram(self, name, values, step):
            """Histograms are not kept."""

        def add_text(self, name, text, step):
            """Text is not kept."""

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
    t_new = time.perf_counter()
    classification_launches = converge_classification(dev) + vgp_full_width(dev)
    multifidelity_launches = converge_multifidelity(dev)
    max_abs_err, multifidelity_full_width_launches, encoded_launches = multifidelity_full_width(
        dev, max_abs_err
    )
    print(f"phases 22-25 seconds: {time.perf_counter() - t_new:.2f}; phases 1-25 seconds: "
          f"{time.perf_counter() - t_start:.2f}")
    t_new = time.perf_counter()
    gpr_mcmc_launches = converge_gpr_mcmc(dev)
    gpr_mcmc_full_width_launches = gpr_mcmc_full_width(
        hartmann_model, hartmann_data, hartmann_space, dev
    )
    summaries_launches = summaries_profiling_objectives(dev)
    print(f"phases 26-28 seconds: {time.perf_counter() - t_new:.2f}")
    print(f"phases 1-28 seconds: {time.perf_counter() - t_start:.2f}")
    t_new = time.perf_counter()
    deep_models_launches = converge_deep_models(dev)
    deep_models_full_width_launches = deep_models_full_width(hartmann_data, hartmann_space, dev)
    print(f"phases 29-30 seconds: {time.perf_counter() - t_new:.2f}")
    print(f"phases 1-30 seconds: {time.perf_counter() - t_start:.2f}")
    max_abs_err, multi_device_launches = multi_device(
        hartmann_model, hartmann_final, hartmann_space, dev, max_abs_err
    )
    print(f"phases 1-31 seconds: {time.perf_counter() - t_start:.2f}")
    max_abs_err, examples_launches = run_examples(max_abs_err)
    print(f"phases 1-32 seconds: {time.perf_counter() - t_start:.2f}")

    # -- phase 33: kernels -----------------------------------------------------------
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
        "launches_classification": classification_launches,
        "launches_multifidelity": multifidelity_launches,
        "launches_multifidelity_full_width": multifidelity_full_width_launches,
        "launches_encoded_full_width": encoded_launches,
        "launches_gpr_mcmc": gpr_mcmc_launches,
        "launches_gpr_mcmc_full_width": gpr_mcmc_full_width_launches,
        "launches_summaries_quickstart": summaries_launches,
        "launches_deep_models": deep_models_launches,
        "launches_deep_models_full_width": deep_models_full_width_launches,
        "launches_multi_device": multi_device_launches,
        "launches_examples": examples_launches,
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
    if sys.argv[1:2] == ["--multi-device-rank"]:
        rank, world, coordinator, workdir = sys.argv[2:6]
        sys.exit(multi_device_rank(int(rank), int(world), coordinator, workdir))
    sys.exit(main())
