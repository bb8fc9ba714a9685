"""HiFiGAN generator as a ``torch.nn.Module``.

Counterpart of ``vocoder_tpu/models/hifigan.py`` (``apply``, with or
without a template and ``frame_lengths``), the reference's SiLU MRF
variant: conv_pre -> per upsample stage (SiLU -> weight-normed transposed
conv -> [+ the noise conv of the f0 template] -> the mean of the parallel
resblocks) -> SiLU -> conv_post -> tanh.  Each resblock runs, per dilation
d, SiLU -> conv(k, d) -> SiLU -> conv(k) -> + x.  Submodule names follow the
reference, so the state_dict keys are the reference's (``conv_pre``,
``ups.{i}``, ``noise_convs.{i}``, ``resblocks.{i}.blocks.{j}.convs{1,2}.{l}``,
``conv_post``).

With ``use_template=True`` the forward takes an f0 template (B, 1, F * hop)
(``data/f0.py``): after upsample i, a plain conv (``noise_convs.{i}``, no
weight norm, 1 -> the stage's channels) decimates it to the stage's rate by
s = prod(upsample_rates[i+1:]) (kernel 2s, padding s // 2; kernel 1 at the
last stage) and its output is added to the stream (``NoiseConvs``).

``frame_lengths`` (B,) makes a right-padded batch exact: every conv output
is masked past each item's length (scaled by each upsample rate), so row i
equals item i's forward over its first ``frame_lengths[i]`` frames.

With ``checkpointing`` (the JAX package's ``jax.checkpoint`` over
``_parallel_block_apply``) training runs each stage's parallel resblock group
again in the backward instead of keeping its activations
(``nn.checkpointed``); eval mode ignores it.

The model has no kernel of its own: the JAX package left its convs to XLA
and no Pallas kernel, so here they are ``torch.nn`` layers (cuDNN on the
card).

Tensor parallelism (``param_specs``, the JAX package's ``param_specs``;
``parallel/tp.py``): conv_pre is column-parallel, and through every stage of
at least ``tp_specs.MIN_CHANNELS`` channels the activations stay channel
shards: each transposed conv and resblock conv is row-parallel, its partial
sums reduced back to this rank's shard, and SiLU, the masks, the residuals
and the template's (column-parallel) noise convs act on the shard.  A
narrower stage and conv_post run whole on every rank.
"""

from __future__ import annotations

import dataclasses
from math import prod

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vocoder_tpu_torch.nn import checkpointed, conv1d, conv_transpose1d, get_padding, length_mask
from vocoder_tpu_torch.parallel import tp, tp_specs
from vocoder_tpu_torch.utils.spans import span


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    hop_length: int = 512
    upsample_rates: tuple = (8, 8, 2, 2, 2)
    upsample_kernel_sizes: tuple = (16, 16, 8, 2, 2)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 128
    upsample_initial_channel: int = 512
    use_template: bool = False
    pre_conv_kernel_size: int = 7
    post_conv_kernel_size: int = 7
    checkpointing: bool = False  # training recomputes each parallel resblock group in the backward

    def __post_init__(self):
        if prod(self.upsample_rates) != self.hop_length:
            raise ValueError(f"upsample rates {self.upsample_rates} do not multiply to hop {self.hop_length}")


class ResBlock(nn.Module):
    """Per dilation d: SiLU -> conv(k, d) -> mask -> SiLU -> conv(k) -> mask -> + x."""

    def __init__(self, channels: int, kernel_size: int, dilations: tuple, device=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        k = kernel_size
        self.convs1 = nn.ModuleList(
            [conv1d(channels, channels, k, dilation=d, padding=get_padding(k, d), device=device) for d in dilations]
        )
        self.convs2 = nn.ModuleList(
            [conv1d(channels, channels, k, padding=get_padding(k), device=device) for _ in dilations]
        )

    def forward(self, x: torch.Tensor, lens=None) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = F.silu(length_mask(tp.conv(c1, F.silu(x)), lens))
            x = x + length_mask(tp.conv(c2, xt), lens)
        return x


class ParallelBlock(nn.Module):
    """The mean of one resblock per (kernel size, dilations) pair."""

    def __init__(self, channels: int, cfg: HiFiGANConfig, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            [ResBlock(channels, k, d, device) for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)]
        )

    def forward(self, x: torch.Tensor, lens=None) -> torch.Tensor:
        return sum(blk(x, lens) for blk in self.blocks) / len(self.blocks)


def noise_convs(cfg, device=None) -> nn.ModuleList:
    """The f0 template's plain convs, one per upsample stage of ``cfg`` (HiFiGAN's or BigVGAN's):
    1 -> the stage's channels, stride s = prod(upsample_rates[i+1:]), kernel 2s, padding s // 2, so
    that a template of F * hop samples becomes the stage's F * prod(rates[:i+1]); kernel 1 at the last."""
    convs = []
    for i in range(len(cfg.upsample_rates)):
        c_out = cfg.upsample_initial_channel // 2 ** (i + 1)
        s = prod(cfg.upsample_rates[i + 1 :])
        if i + 1 < len(cfg.upsample_rates):
            convs.append(nn.Conv1d(1, c_out, 2 * s, stride=s, padding=s // 2, device=device))
        else:
            convs.append(nn.Conv1d(1, c_out, 1, device=device))
    return nn.ModuleList(convs)


def add_noise(x: torch.Tensor, conv: nn.Conv1d, template: torch.Tensor, lens) -> torch.Tensor:
    """x + the stage's noise conv of the template, masked past each item's length."""
    return length_mask(x + tp.conv(conv, template), lens)


def check_template(cfg, template) -> None:
    """A generator built with ``use_template`` needs a template, and one built without takes none."""
    if cfg.use_template and template is None:
        raise ValueError("this generator was built with use_template=True: pass the f0 template waveform "
                         "(B, 1, F * hop), e.g. data/f0.py::f0_template of the audio")
    if template is not None and not cfg.use_template:
        raise ValueError("a template was given to a generator built without use_template")


def upsampler_specs(cfg, stage_specs) -> dict:
    """The tensor-parallel specs (``parallel/tp_specs.py``) of HiFiGAN's skeleton, which BigVGAN shares:
    conv_pre column-parallel, each upsample row-parallel, each noise conv column-parallel, and
    ``stage_specs(i, c)``'s for stage i of c channels; each gated by its width, conv_post replicated."""
    uic = cfg.upsample_initial_channel
    specs = {"conv_pre": tp_specs.col_conv(uic)}
    for i in range(len(cfg.upsample_rates)):
        c_in, c_out = uic // 2**i, uic // 2 ** (i + 1)
        specs[f"ups.{i}"] = tp_specs.row_up(c_in, c_out)
        if cfg.use_template:
            specs[f"noise_convs.{i}"] = tp_specs.noise_conv(c_out)
        specs.update(stage_specs(i, c_out))
    return {k: v for k, v in specs.items() if v is not None}


def param_specs(cfg: HiFiGANConfig) -> dict:
    """{module name: tp_specs.Spec} (``vocoder_tpu/models/hifigan.py::param_specs``): the skeleton's,
    and every resblock conv of a stage row-parallel."""

    def stage(i: int, c: int) -> dict:
        return {f"resblocks.{i}.blocks.{j}.convs{n}.{k}": tp_specs.row_conv(c, c)
                for j, d in enumerate(cfg.resblock_dilation_sizes) for n in (1, 2) for k in range(len(d))}

    return upsampler_specs(cfg, stage)


class HiFiGAN(nn.Module):
    """mel (B, num_mels, F) [+ template (B, 1, F * hop)] -> waveform (B, 1, F * hop)."""

    model_group = None  # the tensor-parallel group when sharded (parallel/tp.py::shard_module)

    def __init__(self, cfg: HiFiGANConfig, device=None):
        super().__init__()
        self.cfg = cfg
        uic = cfg.upsample_initial_channel
        self.conv_pre = conv1d(
            cfg.num_mels, uic, cfg.pre_conv_kernel_size, padding=get_padding(cfg.pre_conv_kernel_size), device=device
        )
        self.ups = nn.ModuleList(
            [
                conv_transpose1d(uic // 2**i, uic // 2 ** (i + 1), k, stride=u, padding=(k - u) // 2, device=device)
                for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes))
            ]
        )
        if cfg.use_template:
            self.noise_convs = noise_convs(cfg, device)
        self.resblocks = nn.ModuleList(
            [ParallelBlock(uic // 2 ** (i + 1), cfg, device) for i in range(len(cfg.upsample_rates))]
        )
        ch = uic // 2 ** len(cfg.upsample_rates)
        self.conv_post = conv1d(
            ch, 1, cfg.post_conv_kernel_size, padding=get_padding(cfg.post_conv_kernel_size), device=device
        )
        self.up_spans = tuple(f"gen.up.{i}" for i in range(len(cfg.upsample_rates)))
        self.stage_spans = tuple(f"gen.stage.{i}" for i in range(len(cfg.upsample_rates)))

    def forward(self, mel: torch.Tensor, frame_lengths=None, template=None) -> torch.Tensor:
        """mel (B, num_mels, F) -> (B, 1, F * hop); ``frame_lengths`` (B,): each item's frames;
        ``template`` (B, 1, F * hop): the f0 template, required with ``use_template``.  Inside the span
        ``gen.forward``: each upsample (SiLU, the transposed conv, its mask and the template's noise) in
        ``gen.up.{i}``, each stage's parallel resblocks in ``gen.stage.{i}``."""
        with span("gen.forward"):
            check_template(self.cfg, template)
            dtype = self.conv_post.bias.dtype
            lens = None if frame_lengths is None else torch.as_tensor(frame_lengths, device=mel.device)
            remat = self.cfg.checkpointing and self.training and torch.is_grad_enabled()
            x = length_mask(tp.conv(self.conv_pre, mel.to(dtype)), lens)
            for i, (up, block, u) in enumerate(zip(self.ups, self.resblocks, self.cfg.upsample_rates)):
                with span(self.up_spans[i]):
                    x = tp.conv(up, F.silu(x))
                    if lens is not None:
                        lens = lens * u
                        x = length_mask(x, lens)
                    if template is not None:
                        x = add_noise(x, self.noise_convs[i], template.to(dtype), lens)
                with span(self.stage_spans[i]):
                    x = checkpointed(block, x, lens) if remat else block(x, lens)
            x = tp.whole(x, self.conv_post.in_channels, self.model_group)
            return length_mask(torch.tanh(self.conv_post(F.silu(x))), lens)


def random_state_dict(cfg: HiFiGANConfig, seed: int) -> dict[str, torch.Tensor]:
    """fp32 CPU weights for ``HiFiGAN(cfg)`` made from a numpy seed, as
    ``models/bigvgan.py::random_state_dict`` makes BigVGAN's: weight-norm directions
    standard normal, gains that keep the signal's scale, small biases.  The
    transposed convs' gains are sqrt(rate), against BigVGAN's sqrt(rate / 2), for
    the SiLU before each; 0.5 in the resblocks, 0.2 at conv_pre for a log-mel's
    offset, 0.5 at conv_post (a log-mel at 44.1 kHz gives audio of rms ~0.07).  The template's noise
    convs are plain: see ``noise_conv_weight``."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, val in HiFiGAN(cfg, device="meta").state_dict().items():
        shape = tuple(val.shape)
        if key.startswith("noise_convs.") and key.endswith("weight"):
            arr = noise_conv_weight(rng, shape)
        elif key.endswith("original0"):
            top = key.split(".")[0]
            gain = {"conv_pre": 0.2, "resblocks": 0.5, "conv_post": 0.5}.get(top, 1.0)
            if top == "ups":
                gain = cfg.upsample_rates[int(key.split(".")[1])] ** 0.5
            arr = gain * (1.0 + 0.1 * rng.standard_normal(shape))
        elif key.endswith("original1"):
            arr = rng.standard_normal(shape)
        else:  # bias
            arr = 0.01 * rng.standard_normal(shape)
        sd[key] = torch.from_numpy(np.asarray(arr, np.float32))
    return sd


def noise_conv_weight(rng: np.random.Generator, shape: tuple) -> np.ndarray:
    """A template noise conv's (O, 1, K) weight with variance 4 / K: the template (amplitude 0.1, a
    sine over the window) comes out at ~0.1-0.3, beside a stream of unit scale."""
    return 2.0 * rng.standard_normal(shape) / np.sqrt(shape[-1])
