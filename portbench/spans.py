"""Reductions over the program's own spans in the traced window, shared by the metric readers.

The port opens ``torch.profiler.record_function`` ranges inside its generator
forward (``gen.forward``, ``gen.up.{i}``, ``gen.stage.{i}``) and its GAN
train step (``train.g.*``, ``train.d.*``) while a profiler records
(``vocoder_tpu_torch/utils/spans.py``).  ``Trace`` keeps them among its host
records, on the host's clock.  A reduction picks ranges by a predicate on
their name, and returns None where the window holds no such range (a program
without those spans), so that its reader leaves the metric out.
"""

from __future__ import annotations

import bisect
import statistics

from portbench.trace import WINDOW

SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"})


def starting(*prefixes: str):
    """A predicate on a range's name: it starts with one of ``prefixes``."""
    return lambda name: name.startswith(prefixes)


def named(*names: str):
    """A predicate on a range's name: it is one of ``names``."""
    return frozenset(names).__contains__


def ranges(trace, pred, thread=None) -> list[tuple]:
    """The host records inside the window whose name satisfies ``pred`` (on ``thread`` where given), in
    order of start: (start ns, end ns, name, thread)."""
    a, b = trace.window
    return [r for r in trace.host if a <= r[0] <= b and r[2] != WINDOW and pred(r[2])
            and (thread is None or r[3] == thread)]


def _union(spans) -> tuple[list[int], list[int]]:
    """The union of (start, end) intervals as (starts, ends), sorted and disjoint."""
    starts, ends = [], []
    for s, e in sorted(spans):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def _inside(union, t: int) -> bool:
    starts, ends = union
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def device_s_under(trace, pred) -> float | None:
    """Seconds of device operations (inside the window) launched by a host call that began inside any
    range satisfying ``pred``, on any thread: ``Trace.device_s_under`` over a set of names.  None where the
    window holds no such range or no device operation."""
    found = ranges(trace, pred)
    if not found or not trace.device:
        return None
    union = _union((s, e) for s, e, _, _ in found)
    a, b = trace.window
    total = 0
    for s, e, _, corr in trace.device:
        s, e = max(s, a), min(e, b)
        at = trace.launched_at.get(corr)
        if e > s and at is not None and _inside(union, at):
            total += e - s
    return total / 1e9


def median_host_ms(trace, name: str) -> float | None:
    """The median host duration, in ms, of the ranges ``name`` inside the window."""
    durations = [(e - s) / 1e6 for s, e, _, _ in ranges(trace, named(name))]
    return statistics.median(durations) if durations else None


def _gaps(trace) -> list[tuple[int, int]]:
    """The window's idle device intervals, in order."""
    a, b = trace.window
    gaps, cursor = [], a
    for s, e in trace.busy_intervals():
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if b > cursor:
        gaps.append((cursor, b))
    return gaps


def idle_s_by_span(trace, pred) -> dict[str, float] | None:
    """{range name: idle device seconds}: each gap of the window that begins while the window's thread is
    inside a range satisfying ``pred``, put down to the innermost such range; None where the window's
    thread opened no such range or the window holds no device operation."""
    thread = next(t for s, e, name, t in trace.host if name == WINDOW)
    found = ranges(trace, pred, thread)
    if not found or not trace.device:
        return None
    totals = dict.fromkeys((name for _, _, name, _ in found), 0)
    stack: list = []
    i = 0
    for gs, ge in _gaps(trace):
        while i < len(found) and found[i][0] <= gs:
            while stack and stack[-1][1] < found[i][0]:
                stack.pop()
            stack.append(found[i])
            i += 1
        while stack and stack[-1][1] < gs:
            stack.pop()
        if stack:
            totals[stack[-1][2]] += ge - gs
    return {name: ns / 1e9 for name, ns in totals.items()}


def idle_share_in(trace, pred) -> float | None:
    """100 x the idle device time in gaps that begin inside a range satisfying ``pred`` / the window."""
    by_span = idle_s_by_span(trace, pred)
    if by_span is None or trace.window_s <= 0:
        return None
    return 100.0 * sum(by_span.values()) / trace.window_s


def sync_calls(trace, pred) -> int | None:
    """How many runtime synchronisations (``SYNCS``) began inside a range satisfying ``pred``, on any
    thread; None where the window holds no such range."""
    found = ranges(trace, pred)
    if not found:
        return None
    union = _union((s, e) for s, e, _, _ in found)
    a, b = trace.window
    return sum(1 for s, _, name, _ in trace.host if name in SYNCS and a <= s <= b and _inside(union, s))


def traced_audio_s(run) -> float:
    """Seconds of audio (the items' own frames) of the forwards that ran inside the traced window."""
    audio = run.cfg["audio"]
    return sum(sum(frames) for frames in run.traced_forwards) * audio["hop_length"] / audio["sampling_rate"]


def device_ms_per_audio_s(run, pred) -> float | None:
    """Device ms launched inside ranges satisfying ``pred`` per second of the traced forwards' audio."""
    if run.trace is None or not run.traced_forwards:
        return None
    spent = device_s_under(run.trace, pred)
    audio_s = traced_audio_s(run)
    return None if spent is None or audio_s <= 0 else 1e3 * spent / audio_s
