"""Explicit device-to-host reads per step: the program's ``host_reads`` counter inside
the step's outermost spans (each span carries the counter's growth while it was open), a
mean over the traced run's recorded steps."""
from benchmarks.harness.spec import load_module


def read(run):
    program = load_module("metrics", "program")
    recorded = program.steps(run)
    if recorded is None:
        return None
    per_step = []
    for records in recorded:
        ids = {r.id for r in records}
        per_step.append(sum(r.host_reads for r in records if r.parent not in ids))
    return program.mean(per_step)
