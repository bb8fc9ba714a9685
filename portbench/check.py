"""The comparison that decides ``correct``: the numbers a run compares, and each beside its limit.

Synthesis: ``wave_gap``, the largest relative L2 distance ||y - y_ref|| /
||y_ref|| over the checked items' waveforms (each item's own samples).

Training: ``loss_gap``, the largest relative gap of the generator's and the
discriminators' losses over the checked steps; ``grad_gap``, the worst
leaf's gap between the norms of the first step's gradient, |‖g‖ - ‖g_ref‖|
over the larger of ‖g_ref‖ and the median leaf's ‖g_ref‖ (each module, the
generator and the discriminators, with its own median); ``change_gap``, the
median leaf's gap of the same kind in each leaf's change over the checked
steps, leaving out leaves whose reference gradient is under a thousandth of
the median leaf's (they move by round-off alone under Adam).  The median and
not the worst leaf: the worst leaf's change swings from seed to seed with the
Snake parameters whose gradient elements lie near Adam's epsilon (1e-6), where
a rounding of the gradient moves the update; a state left unchanged still
reads 1.

A limit file, ``limits/<workload>.json``, gives each number its ``limit`` and
the readings it was set from.  A number is correct when it is at most its
limit; NaN never is.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

import numpy as np


def rel_l2(y: np.ndarray, ref: np.ndarray) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    if y.shape != ref.shape:
        return math.inf
    return float(np.linalg.norm(y - ref) / max(np.linalg.norm(ref), 1e-30))


def wave_gap(outputs: list, refs: list) -> dict:
    return {"wave_gap": max(rel_l2(y, r) for y, r in zip(outputs, refs, strict=True))}


def leaf_gaps(prog: dict, ref: dict, keys) -> list[tuple[float, str]]:
    """(gap, leaf) of each leaf, worst first: |prog - ref| over the larger of ref and the median ref."""
    keys = list(keys)
    if not keys:
        return []
    med = statistics.median(ref[k] for k in keys)
    return sorted(((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k) for k in keys), reverse=True)


def train_gaps(prog: dict, ref: dict, modules: dict) -> dict:
    """``prog``/``ref``: {"losses": [(g, d)] a step, "first_grads": {leaf: norm}, "changes": {leaf: norm}};
    ``modules``: {module: [its leaves]}."""
    loss = max(abs(p - r) / max(abs(r), 1e-30) for ps, rs in zip(prog["losses"], ref["losses"], strict=True)
               for p, r in zip(ps, rs))
    grad = max(max((g for g, _ in leaf_gaps(prog["first_grads"], ref["first_grads"], keys)), default=0.0)
               for keys in modules.values())
    change = 0.0
    for keys in modules.values():
        med = statistics.median(ref["first_grads"][k] for k in keys)
        moved = [k for k in keys if ref["first_grads"][k] >= 1e-3 * med]
        gaps = [g for g, _ in leaf_gaps(prog["changes"], ref["changes"], moved)]
        change = max(change, statistics.median(gaps) if gaps else 0.0)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def load_limits(root: Path, workload: str) -> dict:
    path = root / "limits" / f"{workload}.json"
    return json.loads(path.read_text())["limits"] if path.is_file() else {}


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): every reading at most its limit, and every number limited."""
    table, ok = {}, bool(readings)
    for name, value in readings.items():
        limit = limits.get(name)
        table[name] = {"value": value, "limit": limit}
        if limit is None or not (value <= limit):
            ok = False
    return ok, table
