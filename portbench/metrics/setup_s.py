"""Seconds from the process's start to the window's start: imports, the kernels' build in a fresh checkout,
weights and inputs, the warm-up of every shape (and a training cell's first steps)."""


def read(run):
    return run.setup_s
