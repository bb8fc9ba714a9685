"""RefineGAN generator as a ``torch.nn.Module``.

Counterpart of ``vocoder_tpu/models/refinegan.py`` (the reference's
RefineGAN): a UNet over an f0-derived template waveform (``data/f0.py``).
The template conv, then four downsample stages (LeakyReLU, the skip saved,
linear-interpolation decimation, a ResBlock doubling the channels), the mel
conv concatenated at the bottleneck, four upsample stages (LeakyReLU,
linear-interpolation upsampling, the skip concatenated, a ParallelResBlock:
a plain input conv, then per kernel size (3, 7, 11) AdaIN noise -> ResBlock
-> AdaIN noise, averaged), then LeakyReLU, the output conv and ``tanh``.

State_dict keys are what the JAX package's ``from_torch_state_dict`` reads:
``template_conv``, ``downsample_blocks.{i}.1.convs{1,2}.{j}`` (slot 0 of each
stage holds the parameterless resampler), ``mel_conv``,
``upsample_conv_blocks.{i}.input_conv`` (a plain weight) and
``.blocks.{j}.{0,1,2}`` (AdaIN, ResBlock, AdaIN), ``output_conv``; weight
norm on every conv but the input convs.

AdaIN adds Gaussian noise in training and in inference alike.  The noise is
explicit: ``forward(mel, template, noise)`` draws it from the
``torch.Generator`` ``noise``, on the model's device (a generator on another
device is an error, never a copy); without one, from a fresh generator
seeded 0, so inference is deterministic, as the JAX package's ``rng=None``
is ``jax.random.key(0)``.  The values differ from JAX's noise: the parity
tests make the noise zero on both sides (``adain_noise`` is the one draw).

The linear interpolation (``interp_linear``) is the JAX package's
``_interp_linear``, index math and rounding: out = floor(T * scale),
src = (dst + 0.5) / scale - 0.5 clamped to [0, T - 1] (``F.interpolate``
computes the same indices but rounds the blend differently, by an ulp; a
CPU test holds the port's equal to JAX's bit for bit).  The model has no
kernel of its own: the JAX package left it to XLA, so its convs are
cuDNN's on the card.
"""

from __future__ import annotations

import dataclasses
import math
from math import prod

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vocoder_tpu_torch.nn import conv1d, get_padding
from vocoder_tpu_torch.parallel import dist

DILATIONS = (1, 3, 5)
UP_KERNELS = (3, 7, 11)


@dataclasses.dataclass(frozen=True)
class RefineGANConfig:
    sampling_rate: int = 44100
    hop_length: int = 256
    downsample_rates: tuple = (2, 2, 8, 8)
    upsample_rates: tuple = (8, 8, 2, 2)
    leaky_relu_slope: float = 0.2
    num_mels: int = 128
    start_channels: int = 16

    @property
    def use_template(self) -> bool:
        """RefineGAN always consumes an f0 template (a property, not a field: it cannot be turned off)."""
        return True

    def __post_init__(self):
        if not prod(self.downsample_rates) == prod(self.upsample_rates) == self.hop_length:
            raise ValueError(f"downsample rates {self.downsample_rates} and upsample rates {self.upsample_rates} "
                             f"must both multiply to hop {self.hop_length}")


def interp_linear(x: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, C, T) -> (B, C, floor(T * scale)): linear, align_corners=False, the scale in the index math
    (src = (dst + 0.5) / scale - 0.5 in float64, clamped to [0, T - 1]), then x0 * (1 - w) + x1 * w
    with w in x's dtype, as the JAX package computes it."""
    t_in = x.shape[-1]
    dst = torch.arange(math.floor(t_in * scale), dtype=torch.float64, device=x.device)
    src = ((dst + 0.5) / scale - 0.5).clamp(0.0, t_in - 1)
    i0 = src.floor().long()
    i1 = (i0 + 1).clamp(max=t_in - 1)
    w = (src - i0).to(x.dtype)
    return x[..., i0] * (1.0 - w) + x[..., i1] * w


class Resample(nn.Module):
    """The parameterless linear resampler of a downsample stage (slot 0 of its ``Sequential``)."""

    def __init__(self, scale: float):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return interp_linear(x, self.scale)


class ResBlock(nn.Module):
    """Per dilation d: LeakyReLU -> conv(k, d) -> LeakyReLU -> conv(k, d) -> + x (the first replaces x
    when the block changes the width)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, slope: float, device=None):
        super().__init__()
        self.slope, self.residual_first = slope, in_ch == out_ch
        k = kernel_size
        self.convs1 = nn.ModuleList([conv1d(in_ch if i == 0 else out_ch, out_ch, k, dilation=d,
                                            padding=get_padding(k, d), device=device)
                                     for i, d in enumerate(DILATIONS)])
        self.convs2 = nn.ModuleList([conv1d(out_ch, out_ch, k, dilation=d, padding=get_padding(k, d), device=device)
                                     for d in DILATIONS])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, self.slope)), self.slope))
            x = xt + x if i or self.residual_first else xt
        return x


def adain_noise(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Standard normal noise of x's shape, dtype and device, from ``generator`` (on x's device); inside
    ``parallel.dist.data_parallel`` this rank's rows of the global batch's draw."""
    return dist.batch_draw(lambda s: torch.randn(s, generator=generator, device=x.device, dtype=x.dtype), x.shape)


class AdaIN(nn.Module):
    """x + noise * weight (per channel), then LeakyReLU."""

    def __init__(self, channels: int, slope: float, device=None):
        super().__init__()
        self.slope = slope
        self.weight = nn.Parameter(torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return F.leaky_relu(x + adain_noise(x, generator) * self.weight[:, None], self.slope)


class ParallelResBlock(nn.Module):
    """A plain conv to ``out_ch``, then the mean over kernel sizes (3, 7, 11) of AdaIN -> ResBlock -> AdaIN."""

    def __init__(self, in_ch: int, out_ch: int, slope: float, device=None):
        super().__init__()
        self.input_conv = nn.Conv1d(in_ch, out_ch, 7, padding=3, device=device)
        self.blocks = nn.ModuleList([
            nn.ModuleList([AdaIN(out_ch, slope, device), ResBlock(out_ch, out_ch, k, slope, device),
                           AdaIN(out_ch, slope, device)])
            for k in UP_KERNELS
        ])

    def forward(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        x = self.input_conv(x)
        return sum(a2(res(a1(x, generator)), generator) for a1, res, a2 in self.blocks) / len(self.blocks)


class RefineGAN(nn.Module):
    """mel (B, num_mels, F) + template (B, 1, F * hop) -> waveform (B, 1, F * hop)."""

    draws_noise = True  # forward takes ``noise``, the generator of its AdaIN draws

    def __init__(self, cfg: RefineGANConfig, device=None):
        super().__init__()
        self.cfg = cfg
        slope = cfg.leaky_relu_slope
        ch = cfg.start_channels
        self.template_conv = conv1d(1, ch, 7, padding=3, device=device)
        downs = []
        for rate in cfg.downsample_rates:
            downs.append(nn.Sequential(Resample(1.0 / rate), ResBlock(ch, 2 * ch, 7, slope, device)))
            ch *= 2
        self.downsample_blocks = nn.ModuleList(downs)
        self.mel_conv = conv1d(cfg.num_mels, ch, 7, padding=3, device=device)
        ch *= 2
        ups = []
        for _ in cfg.upsample_rates:
            ups.append(ParallelResBlock(ch + ch // 4, ch // 2, slope, device))
            ch //= 2
        self.upsample_conv_blocks = nn.ModuleList(ups)
        self.output_conv = conv1d(ch, 1, 7, padding=3, device=device)

    def forward(self, mel: torch.Tensor, template: torch.Tensor | None = None,
                noise: torch.Generator | None = None) -> torch.Tensor:
        """``noise``: the AdaIN noise's generator, on the model's device; a fresh one seeded 0 by default."""
        if template is None:
            raise ValueError("RefineGAN needs the f0 template waveform (B, 1, F * hop), e.g. "
                             "data/f0.py::f0_template of the audio")
        slope = self.cfg.leaky_relu_slope
        dtype = self.output_conv.bias.dtype
        if noise is None:
            noise = torch.Generator(device=mel.device).manual_seed(0)
        x = self.template_conv(template.to(dtype))
        skips = []
        for block in self.downsample_blocks:
            x = F.leaky_relu(x, slope)
            skips.append(x)
            x = block(x)
        x = torch.cat([x, self.mel_conv(mel.to(dtype))], dim=1)
        for block, rate, skip in zip(self.upsample_conv_blocks, self.cfg.upsample_rates, reversed(skips)):
            x = interp_linear(F.leaky_relu(x, slope), float(rate))
            x = block(torch.cat([x, skip], dim=1), noise)
        return torch.tanh(self.output_conv(F.leaky_relu(x, slope)))


def random_state_dict(cfg: RefineGANConfig, seed: int) -> dict[str, torch.Tensor]:
    """fp32 CPU weights for ``RefineGAN(cfg)`` made from a numpy seed: weight-norm directions
    standard normal with gains near 1 (0.5 in the ResBlocks' convs, so that the residual branches
    stay below the skip path; 0.2 at the mel conv for a log-mel's offset of about -5; 0.5 at the
    output conv), the plain input convs normal with variance 1 / fan_in, small biases, and AdaIN
    weights near 0.1, so that the noise is heard but does not drown the signal."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, val in RefineGAN(cfg, device="meta").state_dict().items():
        shape = tuple(val.shape)
        top = key.split(".")[0]
        if key.endswith("original0"):
            gain = {"mel_conv": 0.2, "output_conv": 0.5, "template_conv": 1.0}.get(top, 0.5)
            arr = gain * (1.0 + 0.1 * rng.standard_normal(shape))
        elif key.endswith("original1"):
            arr = rng.standard_normal(shape)
        elif key.endswith("input_conv.weight"):
            arr = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif key.endswith("bias"):
            arr = 0.01 * rng.standard_normal(shape)
        else:  # AdaIN weight
            arr = 0.1 * (1.0 + 0.1 * rng.standard_normal(shape))
        sd[key] = torch.from_numpy(np.asarray(arr, np.float32))
    return sd
