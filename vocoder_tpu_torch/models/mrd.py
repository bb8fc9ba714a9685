"""Multi-Resolution (STFT) Discriminator as a ``torch.nn.Module``.

Counterpart of ``vocoder_tpu/models/mrd.py`` (its "plain" backend) and the
reference's: per resolution, the magnitude STFT (no window, i.e. boxcar;
"same_nfft" reflect padding, center off; plain sqrt with a zero subgradient
at zero power) as a (freq, frames) image, then four weight-normed (3, 9)
Conv2d (time strides 1, 2, 2, 2), a (3, 3) one, each with SiLU, a (3, 3) post
conv and the flattened score.  The scores of all resolutions are
concatenated into one (B, sum D) tensor, as the reference does (the loss
then iterates its rows).  State_dict keys are the reference's
(``discriminators.{i}.convs.{j}``, ``discriminators.{i}.conv_post``), which
``vocoder_tpu.models.mrd.from_torch_state_dict`` loads.  The JAX package's
frequency fold (a TPU lane-filling layout) is not ported.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.parametrizations import weight_norm

from vocoder_tpu_torch.ops.spectral import stft_magnitude


@dataclasses.dataclass(frozen=True)
class MRDConfig:
    # (n_fft, hop_length, win_length) per resolution
    resolutions: tuple = ((2048, 512, 2048), (1024, 120, 600), (2048, 240, 1200), (4096, 480, 2400), (512, 50, 240))


_KERNELS = [(3, 9), (3, 9), (3, 9), (3, 9), (3, 3)]
_STRIDES = [(1, 1), (1, 2), (1, 2), (1, 2), (1, 1)]
_PADS = [(1, 4), (1, 4), (1, 4), (1, 4), (1, 1)]


class DiscriminatorR(nn.Module):
    def __init__(self, resolution: tuple):
        super().__init__()
        self.resolution = tuple(resolution)
        chans = [1, 32, 32, 32, 32, 32]
        self.convs = nn.ModuleList(
            [weight_norm(nn.Conv2d(chans[i], chans[i + 1], k, stride=s, padding=p))
             for i, (k, s, p) in enumerate(zip(_KERNELS, _STRIDES, _PADS))]
        )
        self.conv_post = weight_norm(nn.Conv2d(32, 1, (3, 3), padding=(1, 1)))

    def forward(self, audio: torch.Tensor):
        """audio (B, T) -> (score (B, D), feature maps)."""
        n_fft, hop, win = self.resolution
        x = stft_magnitude(audio, n_fft=n_fft, hop_length=hop, win_length=win, padding="same_nfft",
                           mag_mode="plain", window="boxcar")[:, None]  # (B, 1, freq, frames)
        fmap = []
        for conv in self.convs:
            x = F.silu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiResolutionDiscriminator(nn.Module):
    def __init__(self, cfg: MRDConfig):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorR(r) for r in cfg.resolutions])

    def forward(self, audio: torch.Tensor):
        """audio (B, 1, T) -> (scores (B, sum D) concatenated, list of feature-map lists)."""
        outs = [d(audio[:, 0]) for d in self.discriminators]
        return torch.cat([s for s, _ in outs], dim=1), [f for _, f in outs]
