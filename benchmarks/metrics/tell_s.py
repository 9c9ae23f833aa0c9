"""Mean seconds of ``tell()`` (with the objective's evaluation before it) over the traced
window's steps: the benchmark's span, host clock, synchronised at both ends."""


def read(run):
    if not run.trace or not run.steps:
        return None
    return sum(s.tell_s for s in run.steps) / len(run.steps)
