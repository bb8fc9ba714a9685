"""The median of every request's time in the traced run's window (its first seconds under the profiler),
host mel to host waveform, in ms: the steady middle beside ``request_p95_ms``'s tail."""

from portbench import reduce


def read(run):
    return reduce.quantile(run.request_ms, 0.5)
