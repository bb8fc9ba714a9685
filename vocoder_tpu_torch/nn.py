"""Convolution building blocks with the reference's weight norm.

Counterpart of ``vocoder_tpu/nn.py``: ``get_padding``, ``length_mask``,
weight-normed Conv1d / ConvTranspose1d and the inference-time weight-norm
fold.  The modules are plain ``torch.nn`` layers carrying
``torch.nn.utils.parametrizations.weight_norm``, so their state_dict keys are
the reference's (``<name>.parametrizations.weight.original{0,1}``, ``bias``).
The JAX package's time-folded conv layouts are a TPU lane-filling device and
are not carried over: they are exact against the unfolded convs.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils import parametrize
from torch.nn.utils.parametrizations import weight_norm


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def length_mask(x: torch.Tensor, lens: torch.Tensor | None) -> torch.Tensor:
    """Zero positions >= per-item length on a (B, C, T) tensor (no-op for None)."""
    if lens is None:
        return x
    m = torch.arange(x.shape[-1], device=x.device)[None, :] < lens[:, None]
    return x * m[:, None, :].to(x.dtype)


def conv1d(in_ch: int, out_ch: int, kernel_size: int, *, dilation: int = 1, padding: int = 0,
           device=None, dtype=None) -> nn.Conv1d:
    """Weight-normed Conv1d (weight (O, I, K), norm over I and K)."""
    conv = nn.Conv1d(in_ch, out_ch, kernel_size, dilation=dilation, padding=padding, device=device, dtype=dtype)
    return weight_norm(conv)


def conv_transpose1d(in_ch: int, out_ch: int, kernel_size: int, *, stride: int, padding: int,
                     device=None, dtype=None) -> nn.ConvTranspose1d:
    """Weight-normed ConvTranspose1d (weight (I, O, K), norm over O and K)."""
    conv = nn.ConvTranspose1d(in_ch, out_ch, kernel_size, stride=stride, padding=padding, device=device, dtype=dtype)
    return weight_norm(conv)


def fold_weight_norm(module: nn.Module) -> nn.Module:
    """Replace every weight-norm parametrization by its materialised weight,
    in place (the reference's ``remove_parametrizations`` before inference)."""
    for m in module.modules():
        if parametrize.is_parametrized(m, "weight"):
            parametrize.remove_parametrizations(m, "weight", leave_parametrized=True)
    return module
