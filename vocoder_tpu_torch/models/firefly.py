"""Firefly-GAN base generator: a ConvNeXt backbone feeding a HiFiGAN head.

Counterpart of ``vocoder_tpu/models/firefly.py`` (the reference's
firefly-gan-base.yaml, a UnifyGenerator of a ConvNeXtEncoder, depths
(3, 3, 9, 3) and dims (128, 256, 384, 512), and a HiFiGANGenerator whose
``num_mels`` is the backbone's last width).  State_dict keys are the
reference's, under ``backbone.`` and ``head.``.  In training the backbone
drops paths (``drop_path_rate``) with draws from the ``noise`` generator.  No
kernel of its own: cuBLAS, cuDNN on the card.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vocoder_tpu_torch.models import convnext, hifigan


@dataclasses.dataclass(frozen=True)
class FireflyConfig:
    backbone: convnext.ConvNeXtConfig
    head: hifigan.HiFiGANConfig


class Firefly(nn.Module):
    """mel (B, num_mels, F) -> waveform (B, 1, F * hop)."""

    draws_noise = True  # forward takes ``noise``, the generator of the backbone's drop_path draws

    def __init__(self, cfg: FireflyConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = convnext.ConvNeXtEncoder(cfg.backbone, device)
        self.head = hifigan.HiFiGAN(cfg.head, device)

    def forward(self, mel: torch.Tensor, noise: torch.Generator | None = None) -> torch.Tensor:
        x = self.backbone(mel.to(self.head.conv_post.bias.dtype), noise=noise)  # (B, F, dim), channels last
        return self.head(x.transpose(1, 2))


def random_state_dict(cfg: FireflyConfig, seed: int) -> dict[str, torch.Tensor]:
    """fp32 CPU weights for ``Firefly(cfg)`` from a numpy seed: the backbone's as
    ``convnext.random_state_dict`` makes them, the head's as ``hifigan.random_state_dict`` (seed + 1)
    with conv_pre's gain 1, since its input is the backbone's LayerNorm output at unit scale, not a
    log-mel near -5."""
    sd = convnext.random_state_dict(cfg.backbone, seed, prefix="backbone.")
    head = hifigan.random_state_dict(cfg.head, seed + 1)
    head["conv_pre.parametrizations.weight.original0"] *= 5.0
    sd.update({f"head.{k}": v for k, v in head.items()})
    return sd
