"""The median host duration of the port's ``gen.forward`` span over the traced requests, in ms: the time
the host takes to queue one b1 forward (under the profiler, which lengthens it)."""

from portbench import spans


def read(run):
    return None if run.trace is None else spans.median_host_ms(run.trace, "gen.forward")
