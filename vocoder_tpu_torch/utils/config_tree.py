"""Frozen config dataclasses from the plain trees of JSON files (a workdir's ``config.json``, a benchmark file).

One rule for both: a JSON list is a tuple of the config (nested lists
too), and a nested config given as a mapping is built from its items.
``config.py::overlay_task_config`` applies it over a template; a config whose
fields are configs (``VocosConfig``) applies it in its ``__post_init__``.
"""

from __future__ import annotations

from collections.abc import Mapping


def tuplify(v):
    """``v`` with every list, nested ones too, as a tuple."""
    return tuple(tuplify(x) for x in v) if isinstance(v, list) else v


def nested(cls: type, v):
    """``v`` as a ``cls``: a mapping's items as its fields (lists as tuples; an unknown key raises), anything
    else as it is."""
    return cls(**{k: tuplify(x) for k, x in v.items()}) if isinstance(v, Mapping) else v
