"""Resolution and generator presets, and the inference task config.

A copy of the presets in ``vocoder_tpu/config.py`` (resolutions, upsample
factorizations, the BigVGAN generator preset); that module imports the JAX
models, so the port keeps its own.  ``tests/test_torch_models.py`` holds the
two equal field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from vocoder_tpu_torch.models.registry import get_generator

RESOLUTIONS: dict[str, dict] = {
    "44100_512_2048": dict(sampling_rate=44100, num_mels=128, n_fft=2048, hop_length=512, win_length=2048),
    "24000_256_1024": dict(sampling_rate=24000, num_mels=100, n_fft=1024, hop_length=256, win_length=1024),
    "24000_2048_3072": dict(sampling_rate=24000, num_mels=100, n_fft=3072, hop_length=2048, win_length=3072),
    "16000_640_2048": dict(sampling_rate=16000, num_mels=128, n_fft=2048, hop_length=640, win_length=2048),
}

# Upsample-rate factorizations per hop length (prod(rates) == hop).
_UPSAMPLE_PRESETS = {
    512: ((8, 8, 2, 2, 2), (16, 16, 8, 2, 2)),
    256: ((8, 8, 2, 2), (16, 16, 4, 4)),
    2048: ((8, 8, 4, 4, 2), (16, 16, 8, 8, 4)),
    640: ((8, 5, 4, 2, 2), (16, 10, 8, 4, 4)),
}


def upsample_rates_for_hop(hop: int) -> tuple[tuple, tuple]:
    if hop in _UPSAMPLE_PRESETS:
        return _UPSAMPLE_PRESETS[hop]
    # Greedy factorization fallback: rates of 8/5/4/3/2, kernel = 2*rate.
    rates = []
    rem = hop
    for f in (8, 5, 4, 3, 2):
        while rem % f == 0 and rem > 1:
            rates.append(f)
            rem //= f
    if rem != 1:
        raise ValueError(f"cannot factor hop {hop}")
    return tuple(rates), tuple(2 * r for r in rates)


def _gen_bigvgan(res: dict):
    rates, kernels = upsample_rates_for_hop(res["hop_length"])
    return get_generator("bigvgan").config_cls(
        hop_length=res["hop_length"],
        upsample_rates=rates,
        upsample_kernel_sizes=kernels,
        num_mels=res["num_mels"],
        use_template=False,
    )


GENERATOR_PRESETS = {"bigvgan": _gen_bigvgan}


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """What inference needs of the JAX package's GANTaskConfig."""

    sampling_rate: int
    n_fft: int
    hop_length: int
    win_length: int
    num_mels: int
    generator_name: str
    generator: Any


def build_task_config(model: str = "bigvgan", resolution: str = "44100_512_2048") -> TaskConfig:
    if resolution not in RESOLUTIONS:
        raise KeyError(f"unknown resolution {resolution!r}; available: {sorted(RESOLUTIONS)}")
    get_generator(model)  # raises for a generator that is not yet ported
    res = RESOLUTIONS[resolution]
    return TaskConfig(
        sampling_rate=res["sampling_rate"],
        n_fft=res["n_fft"],
        hop_length=res["hop_length"],
        win_length=res["win_length"],
        num_mels=res["num_mels"],
        generator_name=model,
        generator=GENERATOR_PRESETS[model](res),
    )
