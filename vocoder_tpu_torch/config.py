"""Resolution and generator presets, and the inference task config.

A copy of the presets in ``vocoder_tpu/config.py`` (resolutions, upsample
factorizations, the generator presets of the ported families: hifigan,
vocos, vocos_small, vocos_huge and bigvgan); that module imports the JAX
models, so the port keeps its own.  Each preset maps a resolution to the
generator's registry name and its config.  ``tests/test_torch_models.py``
and ``tests/test_torch_hifigan_vocos.py`` hold them equal field by field.
"""

from __future__ import annotations

import dataclasses
import functools
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


def _gen_upsampler(name: str, res: dict):
    """hifigan and bigvgan: the hop's upsample factorization, no template."""
    rates, kernels = upsample_rates_for_hop(res["hop_length"])
    return name, get_generator(name).config_cls(
        hop_length=res["hop_length"],
        upsample_rates=rates,
        upsample_kernel_sizes=kernels,
        num_mels=res["num_mels"],
        use_template=False,
    )


def _gen_vocos(size: str, res: dict):
    from vocoder_tpu_torch.models.convnext import ConvNeXtConfig
    from vocoder_tpu_torch.models.vocos import ISTFTHeadConfig, VocosConfig

    stft = dict(n_fft=res["n_fft"], hop_length=res["hop_length"], win_length=res["win_length"])
    if size == "small":
        # The reference's vocos-small.yaml cannot instantiate; this is its intent, as the JAX
        # package builds it: one depth-8, dim-512 ConvNeXt stage and an iSTFT head.
        return "vocos", VocosConfig(
            backbone=ConvNeXtConfig(input_channels=res["num_mels"], depths=(8,), dims=(512,), drop_path_rate=0.1),
            head=ISTFTHeadConfig(dim=512, **stft),
        )
    return "vocos", getattr(VocosConfig, size)(num_mels=res["num_mels"], **stft)


GENERATOR_PRESETS = {
    "hifigan": functools.partial(_gen_upsampler, "hifigan"),
    "vocos": functools.partial(_gen_vocos, "base"),
    "vocos_small": functools.partial(_gen_vocos, "small"),
    "vocos_huge": functools.partial(_gen_vocos, "huge"),
    "bigvgan": functools.partial(_gen_upsampler, "bigvgan"),
}


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
    """The inference config of a generator preset (``vocos-huge`` reads as ``vocos_huge``) at a resolution."""
    model = model.replace("-", "_")
    if resolution not in RESOLUTIONS:
        raise KeyError(f"unknown resolution {resolution!r}; available: {sorted(RESOLUTIONS)}")
    if model not in GENERATOR_PRESETS:
        get_generator(model)  # raises "not yet ported" for the JAX package's other generators
        raise KeyError(f"unknown generator preset {model!r}; available: {sorted(GENERATOR_PRESETS)}")
    res = RESOLUTIONS[resolution]
    generator_name, generator = GENERATOR_PRESETS[model](res)
    return TaskConfig(
        sampling_rate=res["sampling_rate"],
        n_fft=res["n_fft"],
        hop_length=res["hop_length"],
        win_length=res["win_length"],
        num_mels=res["num_mels"],
        generator_name=generator_name,
        generator=generator,
    )
