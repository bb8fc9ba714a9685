"""Reductions from a run's record to metric values, shared by the metric readers (``metrics/<name>.py``).

A reader is ``read(run) -> float | None``: ``run`` is ``harness.Run`` (the
cell's configuration and traffic, its counts and host-clock times, the traced
window's ``Trace``, the configuration's counts module and the card's peaks).
It returns None where it finds nothing to read, and the harness then leaves
the metric out.  Shares are percentages of the traced window or of a peak,
never clamped: a reading above 100 means the counts or the time are wrong.
"""

from __future__ import annotations

import statistics


def quantile(values, q: float) -> float | None:
    """The q-quantile (0 < q < 1) of ``values`` by ``statistics.quantiles`` (exclusive method)."""
    values = list(values)
    if len(values) < 2:
        return None
    n = 100
    cuts = statistics.quantiles(values, n=n)
    return cuts[round(q * n) - 1]


def idle_share(run) -> float | None:
    """100 x (1 - the union of device operations / the traced window)."""
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def peak_flops(run) -> float | None:
    """The card's dense rate for the configuration's dtype (``peaks.py``), or None off a known card."""
    card = run.peaks
    return None if card is None else card["flops"][run.cfg["dtype"]]


def mfu(run, flops: float) -> float | None:
    """100 x the model FLOPs done in the traced window / (the window's seconds x the peak)."""
    peak = peak_flops(run)
    if run.trace is None or peak is None or not flops or not run.trace.device:
        return None
    return 100.0 * flops / (run.trace.window_s * peak)


def traced_forward_flops(run) -> float:
    """The FLOPs of the forwards that ran inside the traced window, over their items' own frames."""
    return sum(run.counts.forward_flops(run.cfg, sum(frames)) for frames in run.traced_forwards)


def roofline(run, kernel_pattern: str) -> float | None:
    """100 x the least time of the traced forwards' AMP stages (``counts.k2_bound_s``) / the device time of
    kernels whose name holds ``kernel_pattern``."""
    bound_fn = getattr(run.counts, "k2_bound_s", None)
    peak = peak_flops(run)
    if run.trace is None or bound_fn is None or peak is None or not run.traced_forwards:
        return None
    spent = run.trace.device_s(lambda name: kernel_pattern in name)
    if spent <= 0:
        return None
    bound = sum(bound_fn(run.cfg, sum(frames), peak, run.peaks["bytes_per_s"]) for frames in run.traced_forwards)
    return 100.0 * bound / spent
