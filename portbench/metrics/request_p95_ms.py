"""The 95th percentile of every request's time in the window, host mel to host waveform, in ms."""

from portbench import reduce


def read(run):
    return reduce.quantile(run.request_ms, 0.95)
