"""Vocos generator: ConvNeXt backbone + iSTFT head, as a ``torch.nn.Module``.

Counterpart of ``vocoder_tpu/models/vocos.py`` (the reference's
UnifyGenerator with a ConvNeXtEncoder backbone and an ISTFTHead).  The head
projects to 2 * n_fft channels as the reference does (its checkpoints carry
that width), of which only the first n_fft // 2 + 1 of each half feed the
iSTFT: log-magnitudes, exponentiated and clipped at 1e2, and phases.
State_dict keys are the reference's (``backbone.*``, ``head.out``).

The model has no kernel of its own: the JAX package left it to XLA, so its
convs, matmuls and FFTs are the library's (cuDNN, cuBLAS and cuFFT on the
card).  cuFFT has no bf16 inverse real FFT, so the head leaves the model's
dtype after its projection: the exp, the iSTFT and the overlap-add run in
fp32 and the audio is cast back to the model's dtype.

``frame_lengths`` (B,) makes a right-padded batch exact: the backbone masks
each item's padding, and the iSTFT drops the padded frames and divides by
each item's own window envelope.

Tensor parallelism (``param_specs``, the JAX package's): the backbone's
Megatron MLP (``convnext.param_specs``) and the head's projection
column-parallel, its 2 * n_fft channels gathered over the model group before
the magnitude/phase split and the iSTFT, which run whole on every rank.
``VocosConfig.huge()`` (650 M parameters) is the configuration it is for.

``VocosConfig`` takes its nested configs as mappings too (a benchmark file's
or a ``config.json``'s tree), by ``utils/config_tree.py``'s rule.  The
head holds its Hann window on the model's device as a non-persistent buffer
(kept fp32 whatever a cast of the module does), so a forward copies nothing
from the host and the state dict keeps the reference's keys.

Spans (``utils/spans.py``): ``gen.forward`` around the forward, ``gen.head``
around the head (projection, exp and clip, cos and sin, irfft, overlap-add
and envelope); the backbone's ``gen.stage.{i}`` and ``gen.mlp`` are
``convnext.py``'s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from vocoder_tpu_torch.models.convnext import ConvNeXtConfig, ConvNeXtEncoder
from vocoder_tpu_torch.models.convnext import param_specs as convnext_param_specs
from vocoder_tpu_torch.models.convnext import random_state_dict as convnext_random_state_dict
from vocoder_tpu_torch.ops.spectral import hann_window, istft_same
from vocoder_tpu_torch.parallel import tp, tp_specs
from vocoder_tpu_torch.utils.config_tree import nested
from vocoder_tpu_torch.utils.spans import span

MAG_CLIP = 1e2  # the reference's exp clip (vocos.py:58-61)


@dataclasses.dataclass(frozen=True)
class ISTFTHeadConfig:
    dim: int
    n_fft: int
    hop_length: int
    win_length: int
    padding: str = "same"


@dataclasses.dataclass(frozen=True)
class VocosConfig:
    """UnifyGenerator(backbone=ConvNeXtEncoder, head=ISTFTHead)."""

    backbone: ConvNeXtConfig
    head: ISTFTHeadConfig

    def __post_init__(self):
        object.__setattr__(self, "backbone", nested(ConvNeXtConfig, self.backbone))
        object.__setattr__(self, "head", nested(ISTFTHeadConfig, self.head))

    @staticmethod
    def base(num_mels=128, n_fft=2048, hop_length=512, win_length=2048) -> "VocosConfig":
        # configs/model/generator/vocos.yaml
        return VocosConfig(
            backbone=ConvNeXtConfig(
                input_channels=num_mels, depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024), drop_path_rate=0.4
            ),
            head=ISTFTHeadConfig(dim=1024, n_fft=n_fft, hop_length=hop_length, win_length=win_length),
        )

    @staticmethod
    def huge(num_mels=128, n_fft=2048, hop_length=512, win_length=2048) -> "VocosConfig":
        # configs/model/generator/vocos-huge.yaml
        return VocosConfig(
            backbone=ConvNeXtConfig(
                input_channels=num_mels, depths=(3, 3, 27, 3), dims=(352, 704, 1408, 2816), drop_path_rate=0.4
            ),
            head=ISTFTHeadConfig(dim=2816, n_fft=n_fft, hop_length=hop_length, win_length=win_length),
        )


class ISTFTHead(nn.Module):
    """(B, T, dim) -> audio (B, T * hop): the 2 * n_fft projection, then the "same" iSTFT in fp32."""

    def __init__(self, cfg: ISTFTHeadConfig, device=None):
        super().__init__()
        if cfg.padding != "same":
            raise NotImplementedError("only the 'same' iSTFT padding is supported (the shipped configs')")
        self.cfg = cfg
        self.out = nn.Conv1d(cfg.dim, 2 * cfg.n_fft, 1, device=device)
        self.register_buffer("window", self._hann(device), persistent=False)

    def _hann(self, device) -> torch.Tensor:
        return torch.tensor(hann_window(self.cfg.win_length), device=device)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        if self.window.dtype != torch.float32:  # a cast of the module: the iSTFT stays fp32
            self.window = self._hann(self.window.device)
        return self

    def forward(self, x: torch.Tensor, frame_lengths=None) -> torch.Tensor:
        cfg = self.cfg
        bins = cfg.n_fft // 2 + 1
        with span("gen.head"):
            x = tp.linear(self.out, x)  # (B, T, 2 n_fft), or this rank's columns of it
            x = tp.whole(x, 2 * cfg.n_fft, tp.group_of(self.out), dim=-1).float()
            mag = torch.clamp(torch.exp(x[..., :bins]), max=MAG_CLIP)
            phase = x[..., cfg.n_fft : cfg.n_fft + bins]
            re, im = (mag * torch.cos(phase)).transpose(1, 2), (mag * torch.sin(phase)).transpose(1, 2)
            return istft_same(re, im, self.window, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                              win_length=cfg.win_length, frame_lengths=frame_lengths)


def param_specs(cfg: VocosConfig) -> dict:
    """{module name: tp_specs.Spec} (``vocoder_tpu/models/vocos.py::param_specs``): the backbone's MLPs and
    the head's column-parallel projection."""
    return {**convnext_param_specs(cfg.backbone, "backbone."), "head.out": tp_specs.col_linear()}


class Vocos(nn.Module):
    """mel (B, num_mels, F) -> waveform (B, 1, F * hop)."""

    draws_noise = True  # forward takes ``noise``, the generator of the backbone's drop_path draws
    model_group = None  # the tensor-parallel group when sharded (parallel/tp.py::shard_module)

    def __init__(self, cfg: VocosConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = ConvNeXtEncoder(cfg.backbone, device)
        self.head = ISTFTHead(cfg.head, device)

    def forward(self, mel: torch.Tensor, frame_lengths=None, noise: torch.Generator | None = None) -> torch.Tensor:
        """mel (B, num_mels, F) -> (B, 1, F * hop); ``frame_lengths`` (B,): each item's frames; ``noise``: the
        generator of the backbone's drop_path draws in training mode."""
        dtype = self.head.out.weight.dtype
        with span("gen.forward"):
            x = self.backbone(mel.to(dtype), frame_lengths, noise)
            return self.head(x, frame_lengths)[:, None, :].to(dtype)


def random_state_dict(cfg: VocosConfig, seed: int) -> dict[str, torch.Tensor]:
    """fp32 CPU weights for ``Vocos(cfg)`` from a numpy seed: the backbone's as
    ``convnext.random_state_dict`` makes them; the head's projection at 0.5 /
    sqrt(dim), so that the log-magnitudes of the unit-scale features stay
    mostly under the exp clip."""
    sd = convnext_random_state_dict(cfg.backbone, seed, prefix="backbone.")
    rng = np.random.default_rng(seed + 1)
    n = 2 * cfg.head.n_fft
    sd["head.out.weight"] = torch.from_numpy(
        (0.5 / np.sqrt(cfg.head.dim) * rng.standard_normal((n, cfg.head.dim, 1))).astype(np.float32))
    sd["head.out.bias"] = torch.from_numpy((0.05 * rng.standard_normal(n)).astype(np.float32))
    return sd
