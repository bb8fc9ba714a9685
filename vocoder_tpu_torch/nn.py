"""Convolution building blocks with the reference's weight norm.

Counterpart of ``vocoder_tpu/nn.py``: ``get_padding``, ``length_mask``,
weight-normed Conv1d / ConvTranspose1d, the inference-time weight-norm
fold, and ``set_full_precision`` (the JAX package's ``Precision.HIGHEST``).
The modules are plain ``torch.nn`` layers carrying
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


def set_full_precision() -> None:
    """Run the library's fp32 convs and matmuls in full fp32, never TF32.

    The JAX package runs every conv and matmul at ``Precision.HIGHEST``
    (``vocoder_tpu/nn.py::set_default_precision``); PyTorch's default lets
    cuDNN convolutions round fp32 operands to TF32 (about three decimal
    digits).  The entry points call this before they load a model."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def length_mask(x: torch.Tensor, lens: torch.Tensor | None, time_dim: int = -1) -> torch.Tensor:
    """Zero positions >= per-item length along ``time_dim`` (B, C, T by default; no-op for None).

    The masked-batching primitive: re-applied after every time-mixing layer, a
    right-padded batch computes what each item computes alone."""
    if lens is None:
        return x
    t = x.shape[time_dim]
    m = torch.arange(t, device=x.device)[None, :] < lens[:, None]
    shape = [x.shape[0]] + [1] * (x.dim() - 1)
    shape[time_dim] = t
    return x * m.reshape(shape).to(x.dtype)


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
