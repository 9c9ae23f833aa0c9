"""The share of the profiled window in which no kernel, copy or fill ran on the device:
one minus the union of the device's intervals over the window, in percent."""


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
