"""The whole training step's share of the card's peak: the traced steps' model FLOPs
(``counts.train_step_flops``) over the traced window's seconds times the peak of the configuration's dtype."""

from portbench import reduce


def read(run):
    spec = run.traffic
    flops = run.traced_steps * run.counts.train_step_flops(run.cfg, spec["batch"], spec["frames"])
    return reduce.mfu(run, flops)
