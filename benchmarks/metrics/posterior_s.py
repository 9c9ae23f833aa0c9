"""Seconds per step in the posterior's cache builds: the self time of the program's
``posterior.build_cache`` spans, a mean over the traced run's recorded steps. Host clock:
a build's two reads of the noise gate come first and wait for the work queued before
them; the device work the build queues finishes after its span."""
from benchmarks.harness.spec import load_module


def read(run):
    program = load_module("metrics", "program")
    recorded = program.steps(run)
    if recorded is None:
        return None
    per_step = [sum(program.self_seconds(r, records) for r in records
                    if r.name == "posterior.build_cache") for records in recorded]
    return program.mean(per_step)
