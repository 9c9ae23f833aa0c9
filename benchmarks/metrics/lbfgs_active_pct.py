"""The share of the rows given to the objective by the lockstep L-BFGS loops whose run
was still going: 100 times the ``rows_active`` over the ``rows_evaluated`` of the
program's ``lbfgs.minimize`` spans, fits and acquisitions together, over the traced run's
recorded steps. The rest is work the lockstep batch does for runs that have ended."""
from benchmarks.harness.spec import load_module


def read(run):
    recorded = load_module("metrics", "program").steps(run)
    if recorded is None:
        return None
    calls = [r for records in recorded for r in records if r.name == "lbfgs.minimize"]
    evaluated = sum(r.attrs["rows_evaluated"] for r in calls)
    if not evaluated:
        return None
    return 100.0 * sum(r.attrs["rows_active"] for r in calls) / evaluated
