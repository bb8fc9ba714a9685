"""The discriminator phase's mean device time a step over the traced run's window, by CUDA events around
``d_phase``."""

import statistics


def read(run):
    return statistics.fmean(run.d_phase_ms) if run.d_phase_ms else None
