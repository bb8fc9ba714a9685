"""Convolution building blocks with the reference's weight norm.

Counterpart of ``vocoder_tpu/nn.py``: ``get_padding``, ``length_mask``,
weight-normed Conv1d / ConvTranspose1d, the inference-time weight-norm
fold, ``set_full_precision`` (the JAX package's ``Precision.HIGHEST``) and
``full_fp32`` (the same for one block, the flags restored after it),
``drop_path`` (stochastic depth) and ``normal_like``.  Both draw from an
explicit ``torch.Generator`` on that generator's own device and move the
draw to the input's, so a generator on the CPU gives the same draws to a
model on the card as to one on the CPU.  Mixed precision and memory:
``cast_parameters`` (a forward on bf16 copies of a module's parameters whose
gradients reach the fp32 masters, the JAX package's ``_cast_floats`` under
``jax.value_and_grad``), ``cast_copy`` (a detached copy in another dtype) and
``checkpointed`` (``jax.checkpoint``'s counterpart).  Inside
``parallel.dist.data_parallel`` the draws are the global batch's: each rank
draws the global shape and keeps its own rows (``dist.batch_draw``).
The modules are plain ``torch.nn`` layers carrying
``torch.nn.utils.parametrizations.weight_norm``, so their state_dict keys are
the reference's (``<name>.parametrizations.weight.original{0,1}``, ``bias``).
The JAX package's time-folded conv layouts are a TPU lane-filling device and
are not carried over: they are exact against the unfolded convs.
"""

from __future__ import annotations

import contextlib
import copy

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint
from torch.nn.utils import parametrize
from torch.nn.utils.parametrizations import weight_norm

from vocoder_tpu_torch.parallel import dist


def set_full_precision() -> None:
    """Run the library's fp32 convs and matmuls in full fp32, never TF32.

    The JAX package runs every conv and matmul at ``Precision.HIGHEST``
    (``vocoder_tpu/nn.py::set_default_precision``); PyTorch's default lets
    cuDNN convolutions round fp32 operands to TF32 (about three decimal
    digits).  The entry points call this before they load a model."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def full_fp32():
    """cuDNN's convolutions and cuBLAS's matmuls in full fp32 (TF32 off) inside the block, whatever the
    caller set; both flags restored after it."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    set_full_precision()
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


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


def drop_path(x: torch.Tensor, p: float, training: bool, generator: torch.Generator | None) -> torch.Tensor:
    """Stochastic depth per sample: each item of the batch is kept with probability 1 - p and scaled
    by 1 / (1 - p), or zeroed (a mask of shape (B, 1, ...)).  The identity when ``p`` is 0 or when not
    ``training``; otherwise the draw comes from ``generator``, which must be given."""
    if p == 0.0 or not training:
        return x
    if generator is None:
        raise ValueError("drop_path in training needs a torch.Generator for its draws")
    keep = 1.0 - p
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    draws = dist.batch_draw(lambda s: torch.rand(s, generator=generator, device=generator.device), shape)
    return x * (draws < keep).to(x.device, x.dtype) / keep


def normal_like(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Standard normal draws of x's shape and dtype from ``generator``, on x's device."""

    def draw(shape):
        return torch.randn(shape, generator=generator, device=generator.device, dtype=x.dtype)

    return dist.batch_draw(draw, x.shape).to(x.device)


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


@contextlib.contextmanager
def cast_parameters(module: nn.Module, dtype: torch.dtype):
    """Within the block, every floating parameter of ``module`` (weight-norm originals included, so the
    norm runs in ``dtype`` too) is a ``dtype`` copy made by ``.to``: a forward computes in ``dtype`` and
    its backward reaches the masters through the cast.  Buffers stay as they are.  A no-op for a
    parameter already of ``dtype``."""
    swapped = []
    for m in module.modules():
        for name, p in m._parameters.items():
            if p is not None and p.is_floating_point() and p.dtype != dtype:
                swapped.append((m, name, p))
                m._parameters[name] = p.to(dtype)
    try:
        yield module
    finally:
        for m, name, p in swapped:
            m._parameters[name] = p


def cast_copy(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``module`` whose floating parameters are detached ``dtype`` copies (buffers copied as
    they are)."""
    memo = {id(p): nn.Parameter(p.detach().to(dtype), requires_grad=False)
            for p in module.parameters() if p.is_floating_point()}
    return copy.deepcopy(module, memo)


def checkpointed(module: nn.Module, *args):
    """``module(*args)`` with its activations recomputed in the backward (non-reentrant
    ``torch.utils.checkpoint``), on the parameters the module holds now: under ``cast_parameters`` the
    recomputation, which runs after that block has ended, still sees the bf16 copies."""
    params = dict(module.named_parameters())

    def run(*a):
        return torch.func.functional_call(module, params, a)

    return checkpoint(run, *args, use_reentrant=False)
