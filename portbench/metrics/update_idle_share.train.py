"""The device's idle time in gaps that begin while the window's thread is inside the port's
``train.g.update`` or ``train.d.update`` span, as a share of the traced window: the part of
``idle_share.train`` that the optimizer updates leave."""

from portbench import spans

UPDATES = spans.named("train.g.update", "train.d.update")


def read(run):
    return None if run.trace is None else spans.idle_share_in(run.trace, UPDATES)
