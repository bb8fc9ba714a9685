"""Weights and inputs made from ``--seed``: on the device, in a few large calls.

A state dict is one standard-normal draw of all its elements from a
``torch.Generator`` on the device, scaled and shifted per parameter by the
reference's recipe (``init(key) -> (mean, std)``) in one fused operation and
split into views: a handful of launches whatever the number of parameters.
Every stream of draws takes a 64-bit seed made from (``--seed``, a label), so
the same seed gives the same weights and inputs, and different labels draw
independently.
"""

from __future__ import annotations

import hashlib
from math import prod

import numpy as np
import torch


def sub_seed(seed: int, label: str) -> int:
    """A 64-bit seed for the stream ``label`` of run seed ``seed`` (any integer)."""
    digest = hashlib.sha256(f"{seed}:{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, label: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, label))


def rng(seed: int, label: str) -> np.random.Generator:
    """A host generator for draws the host needs (orders, crop starts)."""
    return np.random.default_rng(sub_seed(seed, label))


def state_dict(shapes: dict, init, seed: int, label: str, device) -> dict[str, torch.Tensor]:
    """{key: fp32 tensor of ``shapes[key]`` on ``device``}, each ``mean + std * z`` for
    ``(mean, std) = init(key)`` and z standard normal."""
    keys = list(shapes)
    counts = [prod(shapes[k]) for k in keys]
    stats = torch.tensor([init(k) for k in keys], dtype=torch.float32)
    reps = torch.tensor(counts)
    mean = torch.repeat_interleave(stats[:, 0].to(device), reps.to(device))
    std = torch.repeat_interleave(stats[:, 1].to(device), reps.to(device))
    flat = torch.randn(sum(counts), generator=generator(seed, label, device), device=device)
    flat = torch.addcmul(mean, std, flat)
    return {k: v.view(shapes[k]) for k, v in zip(keys, torch.split(flat, counts))}
