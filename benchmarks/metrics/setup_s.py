"""Seconds from the process's start to the window's: imports, the CUDA context, the
kernel library's load where a cell takes it (its build on a checkout's first run), the
data, the initial fit and the warm-up step."""


def read(run):
    return run.setup_s
