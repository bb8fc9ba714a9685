"""The whole forward's share of the card's peak: the traced forwards' model FLOPs (their items' own frames,
``counts``) over the traced window's seconds times the peak of the configuration's dtype."""

from portbench import reduce


def read(run):
    return reduce.mfu(run, reduce.traced_forward_flops(run))
