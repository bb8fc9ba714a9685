"""The device's idle time in gaps that begin while the window's thread is inside the port's ``gen.forward``
span (the host queueing a forward's launches), as a share of the traced window: the part of
``idle_share.request`` that the forward's own host work leaves."""

from portbench import spans


def read(run):
    return None if run.trace is None else spans.idle_share_in(run.trace, spans.named("gen.forward"))
