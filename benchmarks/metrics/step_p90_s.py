"""The 90th percentile of the latencies of all the window's steps (a restart counts in
the step it precedes). Host clock."""
import statistics


def read(run):
    lat = [s.seconds for s in run.steps]
    if len(lat) < 10:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]
