"""The generator phase's mean device time a step over the traced run's window, by CUDA events around
``g_phase``."""

import statistics


def read(run):
    return statistics.fmean(run.g_phase_ms) if run.g_phase_ms else None
