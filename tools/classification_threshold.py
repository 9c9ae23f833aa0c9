#!/usr/bin/env python3
"""The JAX package's held-out accuracy on the circle classification problem that phase 22
of ``chip_smoke.py`` drives the port through, for the threshold that phase holds the port
to.

    python3 tools/classification_threshold.py --seeds 0 5 --steps 15

Per seed: 10 points drawn by ``Box.sample`` from the first half of ``PRNGKey(seed)``,
labelled ``sum(x²) > 0.5`` on [-1, 1]², ``build_vgp_classifier``, then ``--steps`` steps of
``EfficientGlobalOptimization(BayesianActiveLearningByDisagreement())`` through
``BayesianOptimizer.optimize`` keyed by the second half; the accuracy is that of
``predict_y > 0.5`` at the first 10,000 points of the unrotated 2-D Halton sequence
(bases 2 and 3, indices 1 to 10,000), as the smoke computes it. Runs on the CPU in the JAX
package's default float32; prints one JSON line per seed and one with the worst.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def halton(n: int) -> np.ndarray:
    """Indices 1..n of the Halton sequence in bases 2 and 3, ``[n, 2]`` in [0, 1)."""
    cols = []
    for base in (2, 3):
        i = np.arange(1, n + 1)
        value, f = np.zeros(n), 1.0 / base
        while np.any(i > 0):
            value += f * (i % base)
            i //= base
            f /= base
        cols.append(value)
    return np.stack(cols, axis=-1)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", nargs=2, type=int, default=(0, 5), metavar=("FIRST", "STOP"))
    parser.add_argument("--steps", type=int, default=15)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import trieste_tpu as tt
    from trieste_tpu.acquisition.function.active_learning import (
        BayesianActiveLearningByDisagreement,
    )
    from trieste_tpu.acquisition.rule import EfficientGlobalOptimization
    from trieste_tpu.data import Dataset
    from trieste_tpu.models.gp.vgp import build_vgp_classifier
    from trieste_tpu.space import Box

    space = Box([-1.0, -1.0], [1.0, 1.0])

    def observer(x):
        return Dataset.from_arrays(x, (jnp.sum(x**2, axis=-1, keepdims=True) > 0.5).astype(x.dtype))

    grid = -1.0 + 2.0 * halton(10_000)
    truth = np.sum(grid**2, axis=-1) > 0.5
    accuracies = []
    for seed in range(*args.seeds):
        k_init, k_opt = jax.random.split(jax.random.PRNGKey(seed))
        initial = observer(space.sample(k_init, 10))
        model = build_vgp_classifier(initial, space)
        t0 = time.perf_counter()
        result = tt.BayesianOptimizer(observer, space).optimize(
            args.steps, initial, model,
            EfficientGlobalOptimization(BayesianActiveLearningByDisagreement()),
            key=k_opt, track_state=False,
        )
        final = result.try_get_final_model()
        prob, _ = final.predict_y(jnp.asarray(grid, jnp.float32))
        accuracy = float(np.mean((np.asarray(prob)[:, 0] > 0.5) == truth))
        accuracies.append(accuracy)
        print(json.dumps({"seed": seed, "steps": args.steps, "accuracy": accuracy,
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"worst": min(accuracies), "accuracies": accuracies}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
