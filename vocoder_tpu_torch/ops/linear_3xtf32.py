"""A Linear at fp32 accuracy on the tensor cores (3xTF32), as a hand-written CUDA kernel beside its plain version.

Runs the two GEMMs of each ConvNeXt block's MLP (``models/convnext.py``: pwconv1 with the exact GELU and
pwconv2), ``out = [gelu](x w^T + bias)`` on the last axis.  It replaces no TPU kernel: the JAX package leaves
this matmul to XLA at ``Precision.HIGHEST`` (``vocoder_tpu/nn.py::linear``).  On the card the fp32 product
went to cuBLAS's SGEMM on the CUDA cores, since the port runs fp32 with TF32 off; the kernel
(``csrc/linear_3xtf32.cu``; its header has the design) runs it on the tensor cores in 3xTF32, as K2's fp32
route runs BigVGAN's convs: each operand split into tf32 ``hi + lo`` and three products ``lo·hi + hi·lo +
hi·hi`` summed in fp32, only ``lo·lo`` dropped.
Bound by operations: 3 x 2 M N K at 495 TFLOP/s.  The bias, and for pwconv1 the GELU, are its epilogue,
so the hidden (M, 4C) tensor is written once and read once.

The weight's halves are split once per weight into a (2, N, K) pack (hi, then lo), kept outside the module
by the rule of ``utils/weight_cache.py``; the activation is split inside the kernel.

``linear_3xtf32`` takes a CPU tensor to ``linear_3xtf32_plain`` and launches the kernel for a CUDA tensor,
or raises.  ``linear_3xtf32.launches`` counts launches.  Forward only: ``takes`` is the routing rule
``ConvNeXtBlock`` applies (no gradient recorded, no tensor parallelism, fp32 on the card).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch import nn

from vocoder_tpu_torch.ops import build
from vocoder_tpu_torch.utils.weight_cache import WeightCache

LIB = "linear_3xtf32"  # csrc/linear_3xtf32.cu
KERNEL_DEVICE = "cuda"  # the device type the kernel runs on
ALIGN = 4  # K and N must be multiples of this (TMA's 16-byte row strides, paired stores)

_C_VOID = ctypes.c_void_p
_C_INT = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(LIB)
    lib.linear_3xtf32.argtypes = [_C_VOID, _C_VOID, _C_VOID, _C_VOID, _C_INT, _C_INT, _C_INT, _C_INT, _C_VOID]
    lib.linear_3xtf32.restype = _C_INT
    lib.error_string.argtypes = [_C_INT]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def tf32_split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``v`` as ``hi + lo``, both tf32 values (the low 13 mantissa bits zero), each rounded to nearest
    with ties away from zero: the bits of ``cvt.rna.tf32.f32``, as the kernel splits its operands."""

    def rna(u: torch.Tensor) -> torch.Tensor:
        return ((u.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(v)
    return hi, rna(v - hi)


def linear_3xtf32_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                        gelu: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the three tf32 products of the split operands summed small
    terms first (``lo·hi + hi·lo + hi·hi``), then the bias and the exact GELU.  The kernel sums each 32-deep
    stage's products apart and adds them in order, so the two agree to fp32 rounding, not to the bit."""
    (x_hi, x_lo), (w_hi, w_lo) = tf32_split(x.float()), tf32_split(weight.float())
    y = F.linear(x_lo, w_hi) + F.linear(x_hi, w_lo) + F.linear(x_hi, w_hi)
    if bias is not None:
        y = y + bias
    return F.gelu(y) if gelu else y


weight_packs = WeightCache()  # the Linear -> its (2, N, K) pack


def packed_weight(linear: nn.Linear) -> torch.Tensor:
    """The (2, N, K) pack of ``linear.weight``'s hi and lo halves, kept in ``weight_packs`` by the rule of
    ``utils/weight_cache.py``."""
    return weight_packs.get(linear, (linear,), lambda: torch.stack(tf32_split(linear.weight.detach())))


def takes(x: torch.Tensor, *linears: nn.Linear) -> bool:
    """Whether the kernel runs these Linears on ``x``: fp32 ``x`` on the card, fp32 2-D weights (and biases)
    on its device with K and N multiples of 4, none of them tensor-parallel (``tp_layer``), and no gradient
    recorded (grad mode off, or nothing that requires one)."""
    if x.device.type != KERNEL_DEVICE or x.dtype != torch.float32:
        return False
    params = [p for m in linears for p in m.parameters()]
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        return False
    if any(getattr(m, "tp_layer", None) is not None for m in linears):
        return False
    return (all(p.dtype == torch.float32 and p.device == x.device for p in params)
            and all(m.weight.dim() == 2 and m.weight.shape[0] % ALIGN == 0 and m.weight.shape[1] % ALIGN == 0
                    for m in linears))


def linear_3xtf32_kernel(x: torch.Tensor, linear: nn.Linear, gelu: bool = False) -> torch.Tensor:
    """``[gelu](linear(x))`` on a CUDA fp32 (..., K) tensor: one launch."""
    w, bias = linear.weight, linear.bias
    n, k = w.shape
    if x.dtype != torch.float32 or w.dtype != torch.float32 or (bias is not None and bias.dtype != torch.float32):
        raise TypeError(f"linear_3xtf32: fp32 only, got x {x.dtype}, weight {w.dtype}")
    if x.shape[-1] != k or w.dim() != 2 or k % ALIGN or n % ALIGN:
        raise ValueError(f"linear_3xtf32: x {tuple(x.shape)} against weight {tuple(w.shape)}; K and N must be "
                         f"multiples of {ALIGN}")
    if w.device != x.device or (bias is not None and (bias.device != x.device or not bias.is_contiguous())):
        raise ValueError(f"linear_3xtf32: x on {x.device}, the Linear's parameters on {w.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("linear_3xtf32: x must be contiguous and 16-byte aligned")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or (bias is not None and bias.requires_grad)):
        raise RuntimeError("linear_3xtf32: the kernel is forward only; run it under torch.inference_mode()")
    halves = packed_weight(linear)
    m = x.numel() // k
    out = torch.empty((*x.shape[:-1], n), device=x.device, dtype=torch.float32)
    lib = _lib()
    err = lib.linear_3xtf32(x.data_ptr(), halves.data_ptr(), build.ptr(bias), out.data_ptr(), m, n, k, int(gelu),
                            build.stream_ptr(x.device))
    if err:
        raise RuntimeError(f"linear_3xtf32: launch failed: {lib.error_string(err).decode()}")
    linear_3xtf32.launches += 1
    return out


def linear_3xtf32(x: torch.Tensor, linear: nn.Linear, gelu: bool = False) -> torch.Tensor:
    """``[gelu](linear(x))`` in 3xTF32: the kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.is_cuda:
        return linear_3xtf32_kernel(x, linear, gelu)
    if x.device.type != "cpu":
        raise RuntimeError(f"linear_3xtf32: no kernel for device {x.device}")
    return linear_3xtf32_plain(x, linear.weight, linear.bias, gelu)


linear_3xtf32.launches = 0
