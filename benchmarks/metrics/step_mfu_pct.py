"""The whole step's share of the card's dense TF32 peak: the fixed work of the traced
window's steps (``flops.step_flops``) over the window's seconds times 495 TFLOP/s. The
L-BFGS iterations are left out, so this is a floor that rises only when a step gets
faster."""
from benchmarks.harness.spec import load_module


def read(run):
    if not run.trace or not run.steps or run.window_s <= 0:
        return None
    flops = load_module("metrics", "flops")
    work = sum(flops.step_flops(s, run.cell) for s in run.steps)
    return 100.0 * work / (run.window_s * flops.TF32_PEAK)
