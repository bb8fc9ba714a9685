"""The traced window: ``torch.profiler`` over part of a run's window, read from its raw events.

``Tracer`` starts the profiler (CPU and CUDA activities) after a
``synchronize`` and opens the range ``portbench.window``; a runner polls it
after each item of work, and once ``seconds`` have passed it synchronises,
closes the range and stops, so that every kernel of the traced items lies
inside it.  ``Trace`` reads the profiler's raw events (kineto's, in
nanoseconds on the host's clock, to which the device's are aligned): device
operations (kernels, copies and sets; not the device-side copies of the
ranges), host operations and ranges, and which host call launched each device
operation (by correlation id).
"""

from __future__ import annotations

import bisect
import collections
import time

import torch

WINDOW = "portbench.window"
_LAUNCH_PREFIXES = ("cuda", "cu")


class Tracer:
    """Profiles the first ``seconds`` of a window when ``on``; ``trace`` is the result once stopped."""

    def __init__(self, on: bool, seconds: float):
        self.on, self.seconds = on, seconds
        self.active = False
        self.trace: Trace | None = None
        self._prof = self._range = None
        self._t0 = 0.0

    def start(self) -> None:
        if not self.on:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        self.active = True

    def poll(self) -> None:
        """Stop once the traced seconds have passed (call between items of work)."""
        if self.active and time.perf_counter() - self._t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        self.trace = Trace.from_profile(self._prof)
        self._prof = None


class Trace:
    """Device and host events of one profile, clipped to the ``portbench.window`` range.

    ``host``: (start ns, end ns, name, thread); ``device``: (start ns, end ns, name, correlation id);
    ``launches``: {correlation id: start ns of the host call that launched it}."""

    def __init__(self, host: list, device: list, launches: dict):
        window = [(s, e) for s, e, name, _ in host if name == WINDOW]
        if not window:
            raise RuntimeError(f"the trace has no {WINDOW!r} range")
        self.window = window[0]
        self.host = sorted(host, key=lambda r: (r[0], -r[1]))
        self.device = sorted(device)
        self.launched_at = launches

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        """From the profiler's raw (kineto) events: device events that are not ranges' device-side copies."""
        host, device, launches = [], [], {}
        for e in prof.profiler.kineto_results.events():
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if e.name() != WINDOW or e.is_user_annotation():
                    host.append((start, end, e.name(), e.start_thread_id()))
                if e.name().startswith(_LAUNCH_PREFIXES):
                    launches[e.correlation_id()] = start
            elif not e.is_user_annotation():
                device.append((start, end, e.name(), e.correlation_id()))
        return cls(host, device, launches)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _clipped(self):
        a, b = self.window
        for s, e, name, corr in self.device:
            s, e = max(s, a), min(e, b)
            if e > s:
                yield s, e, name, corr

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals inside the window, in order."""
        out: list[list[int]] = []
        for s, e, _, _ in self._clipped():
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_s(self, pred) -> float:
        """Seconds of device operations (summed, inside the window) whose name satisfies ``pred``."""
        return sum(e - s for s, e, name, _ in self._clipped() if pred(name)) / 1e9

    def device_s_under(self, range_name: str) -> float:
        """Seconds of device operations launched by host calls inside any host range ``range_name``."""
        spans = sorted((s, e) for s, e, name, _ in self.host if name == range_name)
        starts = [s for s, _ in spans]
        total = 0
        for s, e, _, corr in self._clipped():
            at = self.launched_at.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and spans[i][0] <= at <= spans[i][1]:
                total += e - s
        return total / 1e9

    def top_ops(self, n: int = 10) -> list[list]:
        """[[device operation name, seconds]] of the ``n`` names with the most device time."""
        by = collections.Counter()
        for s, e, name, _ in self._clipped():
            by[name] += e - s
        return [[name, ns / 1e9] for name, ns in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """[[what the host was doing, seconds]]: the window's idle device time by the host call that was
        running where each gap began (the innermost ``portbench.*`` range and innermost operation of the
        window's thread), the ``n`` largest totals."""
        a, b = self.window
        busy = self.busy_intervals()
        gaps, cursor = [], a
        for s, e in busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if b > cursor:
            gaps.append((cursor, b))
        thread = next(t for s, e, name, t in self.host if name == WINDOW)
        host = [r for r in self.host if r[3] == thread and r[0] >= a and r[2] != WINDOW]
        totals = collections.Counter()
        stack: list = []
        i = 0
        for gs, ge in gaps:
            while i < len(host) and host[i][0] <= gs:
                while stack and stack[-1][1] < host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < gs:
                stack.pop()
            totals[_label(stack)] += ge - gs
        return [[label, ns / 1e9] for label, ns in totals.most_common(n)]


def _label(stack: list) -> str:
    if not stack:
        return "host between calls"
    ranges = [r[2] for r in stack if r[2].startswith("portbench.")]
    inner = stack[-1][2]
    return f"{ranges[-1]} > {inner}" if ranges and ranges[-1] != inner else inner
