"""The device's idle share of the traced window: 100 x (1 - the union of kernel, copy and set intervals
over the window's length)."""

from portbench import reduce


def read(run):
    return reduce.idle_share(run)
