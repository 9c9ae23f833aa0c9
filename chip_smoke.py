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
   (D = 2, C in {8, 16, 32}, N = 5000); the kernel in fp32 against
   ``fused_predict_reference`` in fp64 on the same inputs, within the TPU kernel's
   contract. A reported case over white-noise targets (rbf, C = 1024) prints the plain
   fp32 version's error beside the kernel's and is held to a small multiple of it;
3. the production shape (N = 131072, C = 1024, D = 6, matern52, P = 1): the kernel, its
   plain version and the unfused torch prediction (Gram, matmul, triangular solve), timed
   with CUDA events, beside the card's fp32 bound for the work the function needs;
4. the main path, convergence: the README quickstart on ScaledBranin with the
   default-noise ``build_gpr`` for up to 20 steps, held to rtol 0.005 of the minimum;
5. the main path at full width: Hartmann6 with 1000 initial points (capacity 1024) and a
   131072-point seed pool, 2 steps;
6. one JSON line describing each kernel. Its ``max_abs_err`` covers every case held to
   the contract, including the kernel on the fitted models that phases 4 and 5 leave
   behind; the white-noise case has keys of its own.

The last line is ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before it; so does a machine without a CUDA device, or a directory without the package.
"""
from __future__ import annotations

import json
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
HBM_RATE = 3.35e12  # H100 SXM device-memory bytes/s, same source
QUICKSTART_SEED = 0
QUICKSTART_STEPS = 20
SCALED_BRANIN_RTOL = 0.005


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


def kernel_and_plain(params, cache, flat):
    """The kernel in fp32 and its plain version in fp64 on the same fp32 operands:
    ``(kernel out, fp64 plain out, fp32 operands)``."""
    from trieste_tpu_torch.ops import fused_predict as fp

    ops = fp.operands(params, cache, flat)
    args = (ops[0],) + tuple(t.float().contiguous() for t in ops[1:])
    out = fp.launch(*args)
    torch.cuda.synchronize()
    plain = fp.fused_predict_reference(args[0], *(t.double() for t in args[1:]))
    return out, plain, args


def fp32_bound(N, n, C, D, P):
    """The least time the card needs for one call, from the work this call's data needs.

    ``n`` of the ``C`` training slots are live and ``LinvT`` is upper triangular on them,
    so ``v = K·L⁻ᵀ`` needs ``n(n+1)/2`` multiply-adds per row; r², the mean and ``Σv²``
    need ``n·(D + P + 1)`` more. Returns ``(FLOP needed, dense FLOP 2·N·C·(C + D + P) as
    the kernel executes it, bytes moved, bound ms, what bounds it)``.
    """
    needed = N * n * (n + 1) + 2.0 * N * n * (D + P + 1)
    dense = 2.0 * N * C * (C + D + P)
    nbytes = 4.0 * (N * D + C * D + C * P + C * C + 2 + N * P + N)
    bound_ms = max(needed / FP32_PEAK, nbytes / HBM_RATE) * 1e3
    bound_by = "operations" if needed / FP32_PEAK >= nbytes / HBM_RATE else "bytes"
    return needed, dense, nbytes, bound_ms, bound_by


def check_on_path(label, model, space, n_pool, gen):
    """Hold the kernel against its plain version on a fitted model of the main path, at
    the seed pool's size; return the larger max abs error of mean and var."""
    from trieste_tpu_torch.ops import fused_predict as fp

    params, cache = model.params, model.posterior_cache
    pool = space.sample(gen, n_pool)
    if not fp.can_fuse(params, cache, pool):
        fail(f"{label}: the fitted model does not pass the fused gate")
    out, plain, args = kernel_and_plain(params, cache, pool)
    em, ev, rm, rv, ok = compare(out, plain)
    C, D = args[2].shape
    print(f"{label} kernel vs plain (fp64) on the fitted model ({args[0]}, N={n_pool} C={C} "
          f"live {int(cache.mask.sum())} D={D}): mean abs {em:.3e} rel {rm:.3e}, var abs "
          f"{ev:.3e} rel {rv:.3e} {'ok' if ok else 'OUT OF TOLERANCE'}")
    if not ok:
        fail(f"{label}: kernel disagrees with its plain version on the fitted model")
    return max(em, ev)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from trieste_tpu_torch import BayesianOptimizer, logging
    from trieste_tpu_torch.acquisition import (
        EfficientGlobalOptimization,
        generate_continuous_optimizer,
    )
    from trieste_tpu_torch.models.gp import build_gpr
    from trieste_tpu_torch.models.gp.posterior import (
        GPRParams,
        _predict_f_flat_reference,
        build_cache,
        predict_f,
    )
    from trieste_tpu_torch.objectives import Hartmann6, ScaledBranin, mk_observer
    from trieste_tpu_torch.ops import fused_predict as fp
    from trieste_tpu_torch.ops.kernels import stationary

    dev = torch.device("cuda")

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
    # (D, N, P values, C values): the production grid with N not a multiple of the
    # kernel's 32-row block, and the quickstart's shapes (D = 2, its 5000-point pool,
    # capacities of one partly filled LinvT panel)
    grids = [(6, 3001, (1, 2, 8), (100, 128, 1000, 1024)), (2, 5000, (1,), (8, 16, 32))]
    cases = 0
    for D, n_pool, Ps, Cs in grids:
        for kind in fp.KINDS:
            for P in Ps:
                for C in Cs:
                    params, cache, g = synthetic_state(
                        kind, C, P, seed=1000 * P + C, device=dev, D=D
                    )
                    flat = torch.rand(n_pool, D, generator=g, dtype=torch.float64, device=dev)
                    out, plain, _ = kernel_and_plain(params, cache, flat)
                    em, ev, rm, rv, ok = compare(out, plain)
                    worst = [max(a, b) for a, b in zip(worst, (em, ev, rm, rv))]
                    cases += 1
                    print(f"phase 2 {kind} D={D} P={P} C={C} N={n_pool}: mean abs {em:.3e} "
                          f"rel {rm:.3e}, var abs {ev:.3e} rel {rv:.3e} "
                          f"{'ok' if ok else 'OUT OF TOLERANCE'}")
                    if not ok:
                        fail(f"kernel disagrees with its plain version: {kind} D={D} P={P} C={C}")
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
    plain_ms = median_ms(lambda: fp.fused_predict_reference(*args), reps=20)
    unfused_ms = median_ms(lambda: _predict_f_flat_reference(params, cache, flat), reps=20)
    flops, dense, nbytes, bound_ms, bound_by = fp32_bound(N, int(cache.mask.sum()), C, D, P)
    dense_ms = dense / FP32_PEAK * 1e3
    print(f"phase 3 production shape N={N} C={C} D={D} matern52 P={P}: kernel {kernel_ms:.3f} ms, "
          f"plain fp32 {plain_ms:.3f} ms, unfused torch (Gram, matmul, solve_triangular) "
          f"{unfused_ms:.3f} ms; fp32 bound {bound_ms:.3f} ms ({flops:.4e} FLOP needed, LinvT "
          f"upper triangular, at {FP32_PEAK / 1e12:.0f} TFLOP/s fp32 without tensor cores; "
          f"{nbytes:.4e} B at {HBM_RATE / 1e12:.2f} TB/s) = {100 * bound_ms / kernel_ms:.1f}% "
          f"of bound; dense count as executed {dense:.4e} FLOP = {dense_ms:.3f} ms "
          f"({100 * dense_ms / kernel_ms:.1f}%, {dense / kernel_ms / 1e9:.2f} TFLOP/s executed)")
    print(f"phase 3 seconds: {time.perf_counter() - t_phase:.2f}")

    # -- phase 4: main path, convergence ------------------------------------------
    t_phase = time.perf_counter()
    minimum = float(ScaledBranin.minimum[0])
    observer = mk_observer(ScaledBranin.objective)
    space = ScaledBranin.search_space  # on cuda, fp32
    gen = torch.Generator(device=dev).manual_seed(QUICKSTART_SEED)
    initial = observer(space.sample(gen, 5))
    model = build_gpr(initial, space)

    def reached(datasets, _models):
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

    # -- phase 6: kernels ------------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "fused_predict",
        "route": "cuda",
        "source": "trieste_tpu_torch/csrc/fused_predict.cu",
        "replaces": "trieste_tpu/ops/fused_predict.py:163",
        "launches": full_width_launches,
        "launches_quickstart": quickstart_launches,
        "max_abs_err": max_abs_err,
        "white_noise_abs_err": white_noise["abs_err"],
        "white_noise_plain_fp32_abs_err": white_noise["plain_fp32_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "unfused_torch_ms": unfused_ms,
        "bound_ms": bound_ms,
        "bound_ms_dense": dense_ms,
        "bound_by": bound_by,
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
