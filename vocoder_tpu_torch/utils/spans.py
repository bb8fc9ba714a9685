"""Named spans inside the program, for the profiler, free when no profiler records.

``span(name)`` is a ``torch.profiler.record_function`` range while a profiler
is recording (kineto records it on the clock of the runtime's launch calls, so
the device work launched inside it is found through each launch's correlation
id), and one shared ``contextlib.nullcontext`` otherwise: with no
profiler it builds no ``RecordFunction``, allocates nothing and formats
nothing, at the cost of one check (``torch.autograd._profiler_enabled``).
The autograd engine carries the profiler's thread-local state into its
backward threads, so a span opened in a backward sees it too.

Callers pass constant names; a name with an index (``gen.up.3``) is built
once, where its module is constructed.  The spans and the metrics that read
them are listed in PERF.md (layers).
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
