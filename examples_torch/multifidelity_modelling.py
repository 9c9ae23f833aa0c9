"""Multifidelity modelling with the autoregressive (AR1) model, on the port.

Counterpart of ``examples/multifidelity_modelling.py`` for ``trieste_tpu_torch``
(reference tutorial ``docs/notebooks/multifidelity_modelling.pct.py``): combine cheap
low-fidelity and expensive high-fidelity observations in one surrogate whose query points
carry a trailing fidelity column.

Run: ``python examples_torch/multifidelity_modelling.py [--device cpu]``
"""
import argparse
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from trieste_tpu_torch.data import Dataset, add_fidelity_column
from trieste_tpu_torch.models.gp.multifidelity import (
    build_multifidelity_autoregressive_models,
)
from trieste_tpu_torch.objectives import Linear2Fidelity
from trieste_tpu_torch.objectives.multifidelity_objectives import linear_multifidelity


def main(*, device: Optional[str] = None) -> dict:
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dtype = torch.float32 if dev.type == "cuda" else torch.float64

    problem = Linear2Fidelity
    space = problem.search_space.to(dev, dtype)
    generator = torch.Generator(device=dev).manual_seed(0)

    # many cheap low-fidelity points, few expensive high-fidelity ones
    X_lo = space.sample(generator, 24)
    X_hi = space.sample(generator, 6)
    qp = torch.cat([add_fidelity_column(X_lo, 0), add_fidelity_column(X_hi, 1)])
    data = Dataset.from_arrays(qp, linear_multifidelity(qp))

    model = build_multifidelity_autoregressive_models(data, 2, space)
    model.update(data)
    model.optimize(data)

    X_test = space.sample(generator, 200)
    truth = linear_multifidelity(add_fidelity_column(X_test, 1))[:, 0]
    mean, var = model.predict(add_fidelity_column(X_test, 1))
    rmse = float((mean[:, 0] - truth).square().mean().sqrt())
    print(f"high-fidelity RMSE from 6 expensive + 24 cheap points: {rmse:.4f}")
    # cross-fidelity covariance at a query point (the AR1 coupling at work)
    cov = float(model.covariance_with_top_fidelity(add_fidelity_column(X_test[:1], 0))[0, 0])
    print(f"cov(low-fidelity obs, top-fidelity latent) at a point: {cov:.4f}")
    return {"rmse": rmse, "covariance_with_top_fidelity": cov}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(device=parser.parse_args().device)
