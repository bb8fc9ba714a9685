"""Warmup-cosine learning-rate schedule.

Counterpart of ``vocoder_tpu/train/schedule.py`` (the reference's
LambdaWarmUpCosineScheduler on base lr 1.0): a linear warmup from
``val_start`` to ``val_base`` over ``warm_up_steps``, then a cosine decay to
``val_final`` over ``max_decay_steps``.  A plain function of the step: the
train step sets each optimizer's lr from it before the update.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class WarmupCosineConfig:
    val_base: float = 1e-4
    val_final: float = 0.0
    max_decay_steps: int = 5_000_000  # trainer.max_steps // 2 (the reference's gan.yaml)
    val_start: float = 0.0
    warm_up_steps: int = 0


def warmup_cosine(step: int, cfg: WarmupCosineConfig) -> float:
    warm = cfg.warm_up_steps
    if step < warm:
        return (cfg.val_base - cfg.val_start) / max(warm, 1) * step + cfg.val_start
    t = min((step - warm) / max(cfg.max_decay_steps - warm, 1), 1.0)
    return cfg.val_final + 0.5 * (cfg.val_base - cfg.val_final) * (1.0 + math.cos(t * math.pi))
