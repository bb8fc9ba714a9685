"""WaveNet posterior encoder as a ``torch.nn.Module``.

Counterpart of ``vocoder_tpu/models/wavenet.py`` (the reference's
PosteriorEncoder, RVC lineage): a 1x1 ``pre`` conv, ``n_layers`` gated
layers (a weight-normed dilated conv to 2 * hidden channels, tanh of one half
times the sigmoid of the other, a weight-normed 1x1 conv to residual and skip
halves; the last layer's is all skip), the sum of the skips, and a 1x1
``proj``; every layer masked by the per-item lengths.  Modes:

- "vqvae": the raw latent (B, out_channels, T);
- "vae": (z, mean, logvar, mask) with ``logvar`` clipped to [-30, 20] and
  z = mean + eps * exp(logvar / 2) in training (eps from the ``noise``
  generator), z = mean in eval mode; masked;
- "bnvae": "vae" with a BatchNorm of the mean whose gain is fixed at 0.5 (the
  reference's KL-collapse guard).  In training it normalises by the batch's
  statistics over batch and time, unmasked as the reference's BatchNorm1d
  never sees the mask, and moves its running ``mean`` and ``var`` buffers
  by momentum 0.1 (the variance unbiased); in eval mode it uses them.
  Inside ``parallel.dist.data_parallel`` the statistics are the global
  batch's: the mean of the all-reduced sums, then the all-reduced sums of
  squared deviations from it (two passes), both differentiable, with the
  global count in the unbiased running variance.

Channels-first (B, C, T) throughout, the convs are ``torch.nn`` layers
(cuDNN on the card): the JAX package ran this encoder outside any Pallas
kernel.  Submodule names are the reference's (``pre``, ``enc.in_layers.{i}``,
``enc.res_skip_layers.{i}``, ``proj``, ``mu_bn``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from vocoder_tpu_torch.nn import conv1d, get_padding, normal_like
from vocoder_tpu_torch.parallel import dist

BN_GAMMA = 0.5  # fixed, not trained (the reference's mu_bn.weight.fill_(0.5), requires_grad=False)
BN_EPS = 1e-5  # torch BatchNorm1d's defaults
BN_MOMENTUM = 0.1
LOGVAR_MIN, LOGVAR_MAX = -30.0, 20.0


@dataclasses.dataclass(frozen=True)
class PosteriorEncoderConfig:
    in_channels: int
    out_channels: int
    hidden_channels: int
    kernel_size: int = 5
    dilation_rate: int = 1
    dilation_cycle: int = 1
    n_layers: int = 16
    mode: str = "vqvae"  # "vae" | "vqvae" | "bnvae"

    def __post_init__(self):
        if self.mode not in ("vae", "vqvae", "bnvae"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.kernel_size % 2 != 1:
            raise ValueError(f"kernel_size {self.kernel_size} must be odd")


class WaveNet(nn.Module):
    """The gated layers: (B, H, T) and a (B, 1, T) mask -> the masked sum of the skips (B, H, T)."""

    def __init__(self, cfg: PosteriorEncoderConfig, device=None):
        super().__init__()
        h, k = cfg.hidden_channels, cfg.kernel_size
        self.hidden = h
        dilations = [cfg.dilation_rate ** (i % cfg.dilation_cycle) for i in range(cfg.n_layers)]
        self.in_layers = nn.ModuleList(
            [conv1d(h, 2 * h, k, dilation=d, padding=get_padding(k, d), device=device) for d in dilations])
        self.res_skip_layers = nn.ModuleList(
            [conv1d(h, 2 * h if i < cfg.n_layers - 1 else h, 1, device=device) for i in range(cfg.n_layers)])

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.hidden
        output = torch.zeros_like(x)
        last = len(self.in_layers) - 1
        for i, (conv_in, conv_rs) in enumerate(zip(self.in_layers, self.res_skip_layers)):
            x_in = conv_in(x)
            res_skip = conv_rs(torch.tanh(x_in[:, :h]) * torch.sigmoid(x_in[:, h:]))
            if i < last:
                x = (x + res_skip[:, :h]) * mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * mask


class FixedGammaBatchNorm(nn.Module):
    """BatchNorm over (B, C, T) with its gain fixed at 0.5: a trained ``bias``, the running ``running_mean``
    and ``running_var`` buffers (torch's names)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            n = x.shape[0] * x.shape[2] * dist.shard()[1]  # the global batch's statistics
            mu = dist.all_reduce_sum_autograd(x.sum(dim=(0, 2))) / n
            var = dist.all_reduce_sum_autograd(torch.square(x - mu[:, None]).sum(dim=(0, 2))) / n
            with torch.no_grad():
                self.running_mean.copy_((1 - BN_MOMENTUM) * self.running_mean + BN_MOMENTUM * mu)
                self.running_var.copy_((1 - BN_MOMENTUM) * self.running_var
                                       + BN_MOMENTUM * (var * (n / max(n - 1, 1))))
        else:
            mu, var = self.running_mean, self.running_var
        return BN_GAMMA * (x - mu[:, None]) * torch.rsqrt(var + BN_EPS)[:, None] + self.bias[:, None]


class PosteriorEncoder(nn.Module):
    """(B, in_channels, T) [+ lengths (B,)] -> see the module docstring, by ``cfg.mode``."""

    def __init__(self, cfg: PosteriorEncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.pre = nn.Conv1d(cfg.in_channels, cfg.hidden_channels, 1, device=device)
        self.enc = WaveNet(cfg, device)
        self.proj = nn.Conv1d(cfg.hidden_channels, cfg.out_channels * (1 if cfg.mode == "vqvae" else 2), 1,
                              device=device)
        if cfg.mode == "bnvae":
            self.mu_bn = FixedGammaBatchNorm(cfg.out_channels, device)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor | None = None, noise: torch.Generator | None = None):
        b, _, t = x.shape
        if lengths is None:
            mask = torch.ones(b, 1, t, dtype=x.dtype, device=x.device)
        else:
            mask = (torch.arange(t, device=x.device)[None, :] < torch.as_tensor(lengths, device=x.device)[:, None])
            mask = mask[:, None, :].to(x.dtype)
        h = self.enc(self.pre(x) * mask, mask)
        out = self.proj(h) * mask
        if self.cfg.mode == "vqvae":
            return out
        c = self.cfg.out_channels
        mean, logvar = out[:, :c], torch.clamp(out[:, c:], LOGVAR_MIN, LOGVAR_MAX)
        if self.cfg.mode == "bnvae":
            mean = self.mu_bn(mean)
        if self.training:
            if noise is None:
                raise ValueError(f"the {self.cfg.mode} posterior in training needs a noise generator for its draws")
            z = (mean + normal_like(mean, noise) * torch.exp(0.5 * logvar)) * mask
        else:
            z = mean * mask
        return z, mean, logvar, mask


def random_state_dict(cfg: PosteriorEncoderConfig, seed: int, prefix: str = "") -> dict[str, torch.Tensor]:
    """fp32 CPU weights for ``PosteriorEncoder(cfg)`` from a numpy seed: weight-norm directions standard
    normal with gains near 1 and plain weights of variance 1 / fan_in (each layer keeps its input's scale),
    small biases, running statistics near the identity."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, val in PosteriorEncoder(cfg, device="meta").state_dict().items():
        shape = tuple(val.shape)
        if key.endswith("original0"):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        elif key.endswith("original1"):
            arr = rng.standard_normal(shape)
        elif key.endswith("weight"):
            arr = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif key.endswith("running_var"):
            arr = 1.0 + 0.1 * np.abs(rng.standard_normal(shape))
        elif key.endswith("running_mean"):
            arr = 0.1 * rng.standard_normal(shape)
        else:  # bias
            arr = 0.05 * rng.standard_normal(shape)
        sd[prefix + key] = torch.from_numpy(np.asarray(arr, np.float32))
    return sd
