"""Seconds per BO step: all the seconds of the window over the steps completed in it
(restarts of episodes included). Host clock; each step ends in a synchronise."""


def read(run):
    return run.window_s / len(run.steps) if run.steps else None
