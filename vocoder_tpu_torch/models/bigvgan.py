"""BigVGAN generator as a ``torch.nn.Module``.

Counterpart of ``vocoder_tpu/models/bigvgan.py`` (``apply``, with or
without a template and ``frame_lengths``): the HiFiGAN upsample skeleton with
Snake/SnakeBeta activations, each wrapped in the anti-aliased 2x up / 2x down
FIRs, AMP resblocks averaged per upsample stage, then a post activation, a
conv and ``tanh``.  Submodule names follow the reference, so the state_dict
keys are the reference's (``conv_pre``, ``ups``, ``noise_convs``,
``resblocks``, ``activation_post``, ``conv_post``).  With ``use_template``
the f0 template's noise convs (``models/hifigan.py::noise_convs``) add to
the stream after each upsample, before the stage; they are ``torch.nn``
convs outside the stages, so K2 still takes every stage at inference (as
the JAX package keeps ``amp_stage_fused`` there) and its packed weights
never hold them.

In eval mode every AMP stage runs through ``ops.amp_block.amp_stage``
(kernel K2 on the card) and ``activation_post`` through
``ops.aa_snake.aa_snake`` (kernel K1); the pre/post convs and the
transposed-conv upsamples are ``torch.nn`` layers, as the JAX package left
them to XLA.  A stage runs block by block instead (``AMPBlock.forward``:
each activation K1, each conv ``torch.nn``), counted in
``BigVGAN.blockwise_stages`` on the kernel path, when the module is in training mode (K2 is
forward only, as the JAX package's fused stage runs only ``not training``)
or when K2 does not take its width (``amp_block.kernel_takes``, decided from
the shape before any launch, as the JAX package's ``amp_stage_supported``).
In training, K1 runs under autograd (``ops.aa_snake.AASnakeFunction``).
With ``checkpointing`` (the JAX package's ``jax.checkpoint`` over
``_amp_apply``) training keeps no activation inside an AMP block and runs
the block again in the backward (``nn.checkpointed``), K1 included: a step
launches K1 90 more times.  Eval mode ignores it.

``frame_lengths`` (B,) makes a right-padded batch exact: every time-mixing
layer's output is masked past each item's length (scaled by each upsample
rate), and the kernels clamp each item's anti-aliased activations at its own
end, so row i equals item i's forward over its first ``frame_lengths[i]``
frames, followed by zeros.  The lengths stay on the device.

Tensor parallelism (``param_specs``, the JAX package's; ``parallel/tp.py``):
HiFiGAN's scheme (``hifigan.upsampler_specs``), with Snake's alpha and beta
sharded with their channels, so that in training every AMP activation runs
K1 on this rank's channel shard.  K2 takes no shard: each of its convs mixes
all input channels, and the JAX package's fused stage, a Pallas call that
GSPMD replicates, runs on gathered operands.  So in eval mode a sharded
stage gathers its input over the model group, runs K2 on the whole stage with
the stage's gathered weights (``tp.whole_blocks``, kept by the rule of
``utils/weight_cache.py``) and keeps this rank's channel shard of the output: the
stages gain no speed from tensor parallelism, as in the JAX package.
``activation_post`` and conv_post run whole on every rank.
"""

from __future__ import annotations

import dataclasses
from math import prod

import numpy as np
import torch
from torch import nn

from vocoder_tpu_torch.models.hifigan import add_noise, check_template, noise_conv_weight, noise_convs, upsampler_specs
from vocoder_tpu_torch.nn import checkpointed, conv1d, conv_transpose1d, get_padding, length_mask
from vocoder_tpu_torch.ops.aa_snake import aa_snake
from vocoder_tpu_torch.ops.amp_block import amp_stage, amp_stage_plain, kernel_takes
from vocoder_tpu_torch.ops.antialias import aa_snake_plain, snake_params
from vocoder_tpu_torch.parallel import tp, tp_specs
from vocoder_tpu_torch.utils.spans import span


@dataclasses.dataclass(frozen=True)
class BigVGANConfig:
    hop_length: int = 512
    upsample_rates: tuple = (8, 8, 2, 2, 2)
    upsample_kernel_sizes: tuple = (16, 16, 8, 2, 2)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 128
    upsample_initial_channel: int = 512
    activation: str = "snakebeta"  # "snake" | "snakebeta"
    snake_logscale: bool = True
    use_template: bool = False
    pre_conv_kernel_size: int = 7
    post_conv_kernel_size: int = 7
    checkpointing: bool = False  # training recomputes each AMP block in the backward

    def __post_init__(self):
        if prod(self.upsample_rates) != self.hop_length:
            raise ValueError(f"upsample rates {self.upsample_rates} do not multiply to hop {self.hop_length}")
        if self.activation not in ("snake", "snakebeta"):
            raise ValueError(f"unknown activation {self.activation!r}")


class Snake(nn.Module):
    """Snake (alpha only) or SnakeBeta parameters; log-scale inits to 0, linear to 1."""

    def __init__(self, channels: int, kind: str, logscale: bool, device=None):
        super().__init__()
        init = torch.zeros if logscale else torch.ones
        self.alpha = nn.Parameter(init(channels, device=device))
        if kind == "snakebeta":
            self.beta = nn.Parameter(init(channels, device=device))
        else:
            self.register_parameter("beta", None)


class Activation1d(nn.Module):
    """Anti-aliased activation: 2x upsample -> snake -> 2x downsample."""

    def __init__(self, activation: Snake, logscale: bool):
        super().__init__()
        self.activation = activation
        self.logscale = logscale

    def forward(self, x: torch.Tensor, lengths=None, plain: bool = False) -> torch.Tensor:
        """K1 (``aa_snake``), or with ``plain`` the plain version (under autograd: autograd through it, on
        the parameters as ``AASnakeFunction`` takes them)."""
        alpha, beta = self.activation.alpha, self.activation.beta
        if plain:
            return aa_snake_plain(x, *snake_params(alpha, beta, self.logscale), lengths)
        return aa_snake(x, alpha, beta, self.logscale, lengths)


class AMPBlock(nn.Module):
    """One AMP resblock: per dilation d, act -> conv(k, d) -> act -> conv(k) -> + x.

    In eval mode a stage's blocks run together in ``amp_stage``; ``forward`` is the
    block alone, the JAX package's ``_amp_apply``, for training and for widths K2
    does not take."""

    def __init__(self, channels: int, kernel_size: int, dilations: tuple, cfg: BigVGANConfig, device=None):
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
        self.activations = nn.ModuleList(
            [
                Activation1d(Snake(channels, cfg.activation, cfg.snake_logscale, device), cfg.snake_logscale)
                for _ in range(2 * len(dilations))
            ]
        )

    def forward(self, x: torch.Tensor, lens=None, plain: bool = False) -> torch.Tensor:
        """x (B, C, T) -> x + the block's residual branches; ``lens`` masks each conv output past
        each item's length; ``plain``: the activations' plain version."""
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            xt = length_mask(tp.conv(c1, self.activations[2 * i](x, lens, plain)), lens)
            xt = length_mask(tp.conv(c2, self.activations[2 * i + 1](xt, lens, plain)), lens)
            x = x + xt
        return x


def param_specs(cfg: BigVGANConfig) -> dict:
    """{module name: tp_specs.Spec} (``vocoder_tpu/models/bigvgan.py::param_specs``): HiFiGAN's
    skeleton, each AMP block's convs row-parallel and its Snake parameters sharded with the channels."""
    n_k = len(cfg.resblock_kernel_sizes)

    def stage(i: int, c: int) -> dict:
        specs = {}
        for j, d in enumerate(cfg.resblock_dilation_sizes):
            name = f"resblocks.{i * n_k + j}"
            specs.update({f"{name}.convs{n}.{k}": tp_specs.row_conv(c, c) for n in (1, 2) for k in range(len(d))})
            specs.update({f"{name}.activations.{a}.activation": tp_specs.snake(c) for a in range(2 * len(d))})
        return specs

    return upsampler_specs(cfg, stage)


class BigVGAN(nn.Module):
    """mel (B, num_mels, F) [+ template (B, 1, F * hop)] -> waveform (B, 1, F * hop)."""

    blockwise_stages = 0  # AMP stages the kernel path ran block by block, over every instance
    model_group = None  # the tensor-parallel group when sharded (parallel/tp.py::shard_module)

    def __init__(self, cfg: BigVGANConfig, device=None):
        super().__init__()
        self.cfg = cfg
        uic = cfg.upsample_initial_channel
        self.conv_pre = conv1d(
            cfg.num_mels, uic, cfg.pre_conv_kernel_size, padding=get_padding(cfg.pre_conv_kernel_size), device=device
        )
        ups, resblocks = [], []
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            c_out = uic // (2 ** (i + 1))
            ups.append(conv_transpose1d(uic // (2**i), c_out, k, stride=u, padding=(k - u) // 2, device=device))
            for k_r, d_r in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                resblocks.append(AMPBlock(c_out, k_r, d_r, cfg, device))
        self.ups = nn.ModuleList(ups)
        if cfg.use_template:
            self.noise_convs = noise_convs(cfg, device)
        self.resblocks = nn.ModuleList(resblocks)
        ch = uic // (2 ** len(cfg.upsample_rates))
        # The post activation is log-scale whatever snake_logscale says (reference bigvgan.py:335-337).
        self.activation_post = Activation1d(Snake(ch, cfg.activation, True, device), True)
        self.conv_post = conv1d(
            ch, 1, cfg.post_conv_kernel_size, padding=get_padding(cfg.post_conv_kernel_size), device=device
        )
        self.up_spans = tuple(f"gen.up.{i}" for i in range(len(cfg.upsample_rates)))
        self.stage_spans = tuple(f"gen.stage.{i}" for i in range(len(cfg.upsample_rates)))

    def forward(self, mel: torch.Tensor, frame_lengths=None, template=None) -> torch.Tensor:
        """mel (B, num_mels, F) -> (B, 1, F * hop); ``frame_lengths`` (B,): each item's frames;
        ``template`` (B, 1, F * hop): the f0 template, required with ``use_template``."""
        return self._forward(mel, frame_lengths, template, plain=False)

    def forward_plain(self, mel: torch.Tensor, frame_lengths=None, template=None) -> torch.Tensor:
        """The same function through the kernels' plain versions on any device:
        what the kernel path is held against on the card."""
        return self._forward(mel, frame_lengths, template, plain=True)

    def _forward(self, mel: torch.Tensor, frame_lengths, template, plain: bool) -> torch.Tensor:
        """The forward inside the span ``gen.forward``: each upsample (the transposed conv, its mask and the
        template's noise) in ``gen.up.{i}``, each stage's AMP blocks in ``gen.stage.{i}``."""
        with span("gen.forward"):
            cfg = self.cfg
            check_template(cfg, template)
            lens = None if frame_lengths is None else torch.as_tensor(frame_lengths, device=mel.device)
            dtype = self.conv_post.bias.dtype
            x = length_mask(tp.conv(self.conv_pre, mel.to(dtype)), lens)
            for i, (up, u) in enumerate(zip(self.ups, cfg.upsample_rates)):
                with span(self.up_spans[i]):
                    x = tp.conv(up, x)
                    if lens is not None:
                        lens = lens * u
                        x = length_mask(x, lens)
                    if template is not None:
                        x = add_noise(x, self.noise_convs[i], template.to(dtype), lens)
                with span(self.stage_spans[i]):
                    x = self._stage(i, x, lens, plain)
            x = tp.whole(x, self.conv_post.in_channels, self.model_group)
            x = self.activation_post(x, lens, plain)
            return length_mask(torch.tanh(self.conv_post(x)), lens)

    def _stage(self, i: int, x: torch.Tensor, lens, plain: bool) -> torch.Tensor:
        """Stage i's AMP blocks on x: K2 (``amp_stage``, on the gathered stage under tensor parallelism) in
        eval mode where it takes the width, else block by block."""
        cfg, mg = self.cfg, self.model_group
        n_k = len(cfg.resblock_kernel_sizes)
        blocks = list(self.resblocks[i * n_k : (i + 1) * n_k])
        c = cfg.upsample_initial_channel // 2 ** (i + 1)
        stage = amp_stage_plain if plain else amp_stage
        if self.training or not kernel_takes(c):
            if not plain:
                BigVGAN.blockwise_stages += 1
            remat = cfg.checkpointing and self.training and torch.is_grad_enabled()
            return sum(checkpointed(blk, x, lens, plain) if remat else blk(x, lens, plain) for blk in blocks) / n_k
        if x.shape[1] < c:  # a channel shard: the whole stage on gathered input and weights
            whole = tp.whole_blocks(blocks, mg, x.device)
            return tp.scatter(stage(whole, tp.gather(x, mg, 1), cfg.snake_logscale, lens), mg, 1)
        return stage(blocks, x, cfg.snake_logscale, lens)


def random_state_dict(cfg: BigVGANConfig, seed: int) -> dict[str, torch.Tensor]:
    """fp32 CPU weights for ``BigVGAN(cfg)`` made from a numpy seed.

    Weight-norm directions are standard normal and the gains near 1, so each
    conv keeps the signal's scale: the transposed convs' gains carry
    sqrt(rate / 2) for the channel halving, the resblock convs' 0.5 keep the
    residual branches below the skip path, conv_pre's 0.2 takes a log-mel's
    offset of about -5 to unit scale and conv_post's 0.25 keeps tanh off its
    rails.  Biases are small and the snake parameters sit near their init.
    The template's noise convs are plain (``hifigan.noise_conv_weight``).
    """
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in BigVGAN(cfg, device="meta").state_dict().items()}
    sd = {}
    for key, shape in shapes.items():
        if key.startswith("noise_convs.") and key.endswith("weight"):
            val = noise_conv_weight(rng, shape)
        elif key.endswith("original0"):
            top = key.split(".")[0]
            gain = {"conv_pre": 0.2, "resblocks": 0.5, "conv_post": 0.25}.get(top, 1.0)
            if top == "ups":
                gain = (cfg.upsample_rates[int(key.split(".")[1])] / 2) ** 0.5
            val = gain * (1.0 + 0.1 * rng.standard_normal(shape))
        elif key.endswith("original1"):
            val = rng.standard_normal(shape)
        elif key.endswith("bias"):
            val = 0.01 * rng.standard_normal(shape)
        else:  # snake alpha / beta
            logscale = cfg.snake_logscale or key.startswith("activation_post.")
            val = (0.0 if logscale else 1.0) + 0.1 * rng.standard_normal(shape)
        sd[key] = torch.from_numpy(np.asarray(val, np.float32))
    return sd
