"""Lockstep L-BFGS iterations of the model fits per step: the ``iterations`` of the
program's ``lbfgs.minimize`` spans inside ``model.fit`` (the ``tell()`` fits, and an
episode's initial fit where the step starts one), a mean over the traced run's recorded
steps."""
from benchmarks.harness.spec import load_module


def read(run):
    return load_module("metrics", "program").lbfgs_iterations(run, "model.fit")
