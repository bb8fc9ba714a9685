"""1-D ConvNeXt encoder as a ``torch.nn.Module``.

Counterpart of ``vocoder_tpu/models/convnext.py`` (the reference's
ConvNeXtEncoder): a stem conv + LayerNorm, per later stage a LayerNorm + 1x1
conv transition, and ConvNeXt blocks (depthwise conv k=7 -> LayerNorm ->
pointwise x mlp_ratio -> exact GELU -> pointwise -> layer scale gamma ->
residual), then a final LayerNorm.  LayerNorm's eps is 1e-6 (the
reference's, not torch's default 1e-5).  Activations are channels-last
(B, T, C) inside, as the JAX package keeps them, so the LayerNorms and the
pointwise layers act on the last axis and only the convs transpose.
Submodule names are the reference's (``downsample_layers.{i}.{0,1}``,
``stages.{i}.{j}.{dwconv,norm,pwconv1,pwconv2,gamma}``, ``norm``).

``frame_lengths`` (B,) makes a right-padded batch exact: only the convs mix
time, so a mask after each stage entry and after every block restores each
item's zero padding before the next depthwise conv sees it.

Stochastic depth (``drop_path_rate``): block i of all n takes rate
``linspace(0, drop_path_rate, n)[i]`` over the blocks of every stage
together (``_drop_rates``), and in training mode, given a ``noise``
generator, drops its branch per sample before the residual add.  Without a
generator, or in eval mode, no branch is dropped.

Tensor parallelism (``param_specs``, the JAX package's Megatron MLP;
``parallel/tp.py``): each block's pwconv1 is column-parallel (this rank's
hidden features; GELU on them) and pwconv2 row-parallel, its partial sums
reduced once a block before the replicated bias, layer scale and residual;
the depthwise convs, the norms and the transitions are replicated.  The
drop_path mask acts on the replicated residual branch, so every rank of a
model group draws the same one (its generator in lockstep, the same rows of
the global batch).

Spans (``utils/spans.py``): ``gen.stage.{i}`` around stage i's entry (the
stem or the transition), its blocks and their masks, and ``gen.mlp`` around
each block's pwconv1 -> GELU -> pwconv2 (the layer scale and the residual
outside it), wherever the encoder runs (Vocos' backbone, Firefly-GAN's, the
vae encoders); the benchmark reads them in its Vocos cell.

The MLP's two GEMMs run on the port's 3xTF32 kernel (``ops/linear_3xtf32.py``: fp32-grade products on
the tensor cores, the bias and pwconv1's GELU in its epilogue) wherever ``linear_3xtf32.takes`` holds:
fp32 on the card, no gradient recorded, neither Linear tensor-parallel.  Training, tensor-parallel
inference, bf16 and the CPU keep ``tp.linear`` (cuBLAS, or PyTorch's CPU matmul);
``ConvNeXtBlock.library_mlps`` counts the MLPs of CUDA tensors that took it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vocoder_tpu_torch.nn import drop_path, length_mask
from vocoder_tpu_torch.ops import linear_3xtf32 as lin3
from vocoder_tpu_torch.parallel import tp, tp_specs
from vocoder_tpu_torch.utils.spans import span

LN_EPS = 1e-6  # vocoder_tpu/nn.py::layer_norm


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    input_channels: int = 3
    depths: tuple = (3, 3, 9, 3)
    dims: tuple = (96, 192, 384, 768)
    drop_path_rate: float = 0.0
    layer_scale_init_value: float = 1e-6
    kernel_size: int = 7
    mlp_ratio: float = 4.0
    dilation: int = 1

    def __post_init__(self):
        if len(self.depths) != len(self.dims):
            raise ValueError(f"depths {self.depths} and dims {self.dims} differ in length")


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with eps 1e-6 (``weight``, ``bias``)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias, LN_EPS)


def conv_time(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A Conv1d on a channels-last (B, T, C) tensor."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


def pointwise(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A kernel-size-1 Conv1d on (B, T, C) as the matmul it is."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


def _drop_rates(cfg: ConvNeXtConfig) -> list[list[float]]:
    """Each block's drop_path rate, by stage: ``linspace(0, drop_path_rate, sum(depths))`` cut by stage."""
    rates = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths))
    bounds = np.cumsum((0,) + tuple(cfg.depths))
    return [[float(r) for r in rates[a:b]] for a, b in zip(bounds[:-1], bounds[1:])]


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, cfg: ConvNeXtConfig, drop_rate: float = 0.0, device=None):
        super().__init__()
        self.drop_rate = drop_rate
        hidden = int(cfg.mlp_ratio * dim)
        pad = cfg.dilation * (cfg.kernel_size - 1) // 2
        self.dwconv = nn.Conv1d(dim, dim, cfg.kernel_size, padding=pad, dilation=cfg.dilation, groups=dim,
                                device=device)
        self.norm = LayerNorm(dim, device)
        self.pwconv1 = nn.Linear(dim, hidden, device=device)
        self.pwconv2 = nn.Linear(hidden, dim, device=device)
        if cfg.layer_scale_init_value > 0:
            self.gamma = nn.Parameter(torch.full((dim,), cfg.layer_scale_init_value, device=device))
        else:
            self.register_parameter("gamma", None)

    library_mlps = 0  # MLPs of CUDA tensors that took tp.linear (cuBLAS) and not the 3xTF32 kernel

    def mlp(self, y: torch.Tensor) -> torch.Tensor:
        """pwconv1 -> exact (erf) GELU, torch's default -> pwconv2: on the 3xTF32 kernel where
        ``linear_3xtf32.takes`` holds, else through ``tp.linear``."""
        if lin3.takes(y, self.pwconv1, self.pwconv2):
            return lin3.linear_3xtf32(lin3.linear_3xtf32(y, self.pwconv1, gelu=True), self.pwconv2)
        if y.is_cuda:
            ConvNeXtBlock.library_mlps += 1
        return tp.linear(self.pwconv2, F.gelu(tp.linear(self.pwconv1, y)))

    def forward(self, x: torch.Tensor, noise: torch.Generator | None = None) -> torch.Tensor:
        y = self.norm(conv_time(self.dwconv, x))
        with span("gen.mlp"):
            y = self.mlp(y)
        if self.gamma is not None:
            y = self.gamma * y
        if noise is not None:
            y = drop_path(y, self.drop_rate, self.training, noise)
        return x + y


def param_specs(cfg: ConvNeXtConfig, prefix: str = "") -> dict:
    """{module name: tp_specs.Spec} (``vocoder_tpu/models/convnext.py::param_specs``): every block's
    pwconv1 column-parallel and pwconv2 row-parallel; the rest replicated."""
    return {f"{prefix}stages.{i}.{j}.{name}": spec() for i, depth in enumerate(cfg.depths) for j in range(depth)
            for name, spec in (("pwconv1", tp_specs.col_linear), ("pwconv2", tp_specs.row_linear))}


class ConvNeXtEncoder(nn.Module):
    """(B, input_channels, T) -> (B, T, dims[-1])."""

    def __init__(self, cfg: ConvNeXtConfig, device=None):
        super().__init__()
        self.cfg = cfg
        stem = nn.ModuleList([
            nn.Conv1d(cfg.input_channels, cfg.dims[0], cfg.kernel_size, padding=cfg.kernel_size // 2, device=device),
            LayerNorm(cfg.dims[0], device),
        ])
        transitions = [
            nn.ModuleList([LayerNorm(cfg.dims[i], device), nn.Conv1d(cfg.dims[i], cfg.dims[i + 1], 1, device=device)])
            for i in range(len(cfg.dims) - 1)
        ]
        self.downsample_layers = nn.ModuleList([stem, *transitions])
        self.stages = nn.ModuleList(
            [nn.ModuleList([ConvNeXtBlock(dim, cfg, rate, device) for rate in rates])
             for rates, dim in zip(_drop_rates(cfg), cfg.dims)]
        )
        self.norm = LayerNorm(cfg.dims[-1], device)
        self.stage_spans = tuple(f"gen.stage.{i}" for i in range(len(cfg.dims)))

    def forward(self, x: torch.Tensor, frame_lengths=None, noise: torch.Generator | None = None) -> torch.Tensor:
        """``noise``: the generator of the drop_path draws, in training mode (block after block)."""
        lens = None if frame_lengths is None else torch.as_tensor(frame_lengths, device=x.device)
        for i, (down, stage) in enumerate(zip(self.downsample_layers, self.stages)):
            with span(self.stage_spans[i]):
                if i == 0:
                    x = down[1](down[0](x).transpose(1, 2))  # the stem takes (B, C, T)
                else:
                    x = pointwise(down[1], down[0](x))
                x = length_mask(x, lens, time_dim=1)  # LN and the 1x1 conv put their biases in the padding
                for block in stage:
                    x = length_mask(block(x, noise), lens, time_dim=1)
        return self.norm(x)


def random_state_dict(cfg: ConvNeXtConfig, seed: int, prefix: str = "") -> dict[str, torch.Tensor]:
    """fp32 CPU weights for ``ConvNeXtEncoder(cfg)`` from a numpy seed: conv and linear
    weights normal with variance 1 / fan_in (each layer keeps its input's scale),
    LayerNorm gains near 1, small biases, and layer scales of 0.1 so that every
    block adds to its residual (the 1e-6 init would leave the blocks silent)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, val in ConvNeXtEncoder(cfg, device="meta").state_dict().items():
        shape = tuple(val.shape)
        name = key.rsplit(".", 1)[-1]
        if name == "gamma":
            arr = 0.1 * (1.0 + 0.1 * rng.standard_normal(shape))
        elif len(shape) > 1:
            arr = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif name == "weight":  # LayerNorm
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            arr = 0.05 * rng.standard_normal(shape)
        sd[prefix + key] = torch.from_numpy(np.asarray(arr, np.float32))
    return sd
