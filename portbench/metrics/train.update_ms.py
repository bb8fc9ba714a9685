"""The optimizer updates' device time a step: device ms launched inside the port's ``train.g.update`` and
``train.d.update`` spans (gradient all-reduce, global values, grad norms, lr, AdamW, EMA) over the traced
steps."""

from portbench import spans

UPDATES = spans.named("train.g.update", "train.d.update")


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    spent = spans.device_s_under(run.trace, UPDATES)
    return None if spent is None else 1e3 * spent / run.traced_steps
