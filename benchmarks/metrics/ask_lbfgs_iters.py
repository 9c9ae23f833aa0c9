"""Lockstep L-BFGS iterations of the acquisition optimizer per step: the ``iterations``
of the program's ``lbfgs.minimize`` spans inside ``acquisition.optimize``, recovery runs
included, a mean over the traced run's recorded steps."""
from benchmarks.harness.spec import load_module


def read(run):
    return load_module("metrics", "program").lbfgs_iterations(run, "acquisition.optimize")
