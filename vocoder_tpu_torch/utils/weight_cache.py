"""Values made from modules' parameters, kept while those parameters stay: the one rule for every such cache.

K2's stage plans (``ops/amp_block.py``), K3's tf32 packs (``ops/linear_3xtf32.py``), the gathered stages of
tensor parallelism (``parallel/tp.py``) and the bf16 eval copy (``train/gan.py``) each keep a ``WeightCache``.
An entry belongs to an owner module and dies with it.  It is fresh while the same modules are asked for with
the same ``extra`` and each of their parameters keeps its stamp ``(data_ptr, _version)``.  An in-place change
bumps ``_version``.  A new Parameter, or ``Module.to`` (which swaps ``.data`` and keeps ``_version``), moves
``data_ptr``, since the entry holds the storages it was made from and no later tensor can take their
addresses; so a new dtype or shape, which needs a new storage, is seen too.  The parameters are read through
the (module, name) slots found at the making, as cheap as the stamp itself (a module walk costs several times
more): a new Parameter in a slot is seen, a submodule swapped for another is not.  A value made from an
inference tensor (no version counter) is made at every call and never kept.  A stale entry is dropped before
its replacement is made, so the two never coexist.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch


@dataclasses.dataclass
class _Entry:
    modules: tuple  # id() of each module the value was made from
    extra: object
    slots: list  # (module._parameters, name) of every parameter of those modules
    stamp: list
    storages: list  # the parameters' storages at the making, held so that no later tensor takes their addresses
    value: object


def _stamp(slots: list) -> list | None:
    try:
        return [(d[name].data_ptr(), d[name]._version) for d, name in slots]
    except RuntimeError:  # an inference tensor made in inference mode has no version counter
        return None


class WeightCache:
    """Owner module -> the value made from some modules' parameters; ``builds`` and ``hits`` count its calls."""

    def __init__(self):
        self._entries = weakref.WeakKeyDictionary()
        self.builds = 0  # values made
        self.hits = 0  # values reused

    def get(self, owner: torch.nn.Module, modules, make, extra=None, agree=bool):
        """``owner``'s value, ``make()`` of the parameters of ``modules`` (and their submodules): the kept one
        while it is fresh, else made anew.  ``agree(fresh)`` decides, where processes must agree on it (every
        one calls it; a rank's entry that is not fresh must not be reused); by default, freshness alone."""
        ids = tuple(map(id, modules))
        entry = self._entries.get(owner)
        fresh = (entry is not None and entry.modules == ids and entry.extra == extra
                 and _stamp(entry.slots) == entry.stamp)
        if agree(fresh):
            self.hits += 1
            return entry.value
        self._entries.pop(owner, None)
        slots = [(m._parameters, name) for module in modules for m in module.modules()
                 for name, p in m._parameters.items() if p is not None]
        tensors = [d[name] for d, name in slots]
        keep = not any(t.is_inference() for t in tensors)  # one wrapped in a Parameter reads a _version of 0
        stamp = _stamp(slots) if keep else None
        value = make()
        if keep:
            self._entries[owner] = _Entry(ids, extra, slots, stamp, [t.untyped_storage() for t in tensors], value)
        self.builds += 1
        return value
