"""Multi-Period Discriminator as a ``torch.nn.Module``.

Counterpart of ``vocoder_tpu/models/mpd.py`` (its "image" backend) and the
reference's: per period p, the waveform is zero-padded on the right to a
multiple of p and viewed as a (T / p, p) image, then weight-normed (k, 1)
Conv2d with stride (3, 1) and SiLU, a (3, 1) post conv, and the flattened
score.  Layout is the reference's NCHW, so the state_dict keys are its
(``discriminators.{i}.convs.{j}``, ``discriminators.{i}.conv_post``) and
``vocoder_tpu.models.mpd.from_torch_state_dict`` loads them as they are.
The JAX package is NHWC: scores flatten in the same order (one channel),
feature maps differ by a permute.  Its "folded" backend (the period folded
into the batch to fill the TPU's sublanes) is TPU machinery and not ported.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.parametrizations import weight_norm


@dataclasses.dataclass(frozen=True)
class MPDConfig:
    periods: tuple = (2, 3, 5, 7, 11)
    kernel_size: int = 5
    stride: int = 3
    channels: tuple = (1, 64, 128, 256, 512, 1024)


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, cfg: MPDConfig):
        super().__init__()
        self.period = period
        k, chs = cfg.kernel_size, cfg.channels
        self.convs = nn.ModuleList(
            [weight_norm(nn.Conv2d(chs[i], chs[i + 1], (k, 1), stride=(cfg.stride, 1), padding=(k // 2, 0)))
             for i in range(len(chs) - 1)]
        )
        self.conv_post = weight_norm(nn.Conv2d(chs[-1], 1, (3, 1), padding=(1, 0)))

    def forward(self, x: torch.Tensor):
        """x (B, 1, T) -> (score (B, D), feature maps)."""
        b, c, t = x.shape
        x = F.pad(x, (0, -t % self.period)).reshape(b, c, -1, self.period)
        fmap = []
        for conv in self.convs:
            x = F.silu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, cfg: MPDConfig):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorP(p, cfg) for p in cfg.periods])

    def forward(self, audio: torch.Tensor):
        """audio (B, 1, T) -> (list of scores (B, D_p), list of feature-map lists)."""
        outs = [d(audio) for d in self.discriminators]
        return [s for s, _ in outs], [f for _, f in outs]
