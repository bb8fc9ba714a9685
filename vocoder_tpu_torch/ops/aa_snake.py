"""K1: the anti-aliased Snake, as a hand-written CUDA kernel beside its plain version.

Replaces the Pallas kernel ``vocoder_tpu/ops/pallas/aa_snake.py::_kernel``
(``pallas_call`` in ``_interior``, wrapped by ``fused_aa_snake``).  The CUDA
source is ``csrc/aa_snake.cu``; the run that computes the activation lives in
``csrc/aa_snake.cuh``, which the AMP conv kernel's prologue shares.  On an
H100 the kernel in bf16 is bound by its fp32 operations (88 per output
sample) rather than by its bytes (one read and one write per sample).  Each thread
computes a run of consecutive outputs in registers, with the FIR taps and the
sin polynomial as FMAs (within a few ulps of the plain version, not bit-equal
to it), from a tile of x that one bulk copy stages in shared memory; the
sequence edges are exact by index clamping, so no edge splice follows it.
With ``lengths`` (a padded batch) each row is clamped at its item's own
length and zero past it, so it equals the activation of that item alone.

``aa_snake`` takes a CPU tensor to the plain version
(``antialias.aa_snake_plain``) and launches the kernel for a CUDA tensor, or
raises.  ``aa_snake.launches`` counts kernel launches, with lengths or
without.

Under autograd (grad enabled and an input that requires it) ``aa_snake``
runs ``AASnakeFunction``: its forward is the kernel on a CUDA tensor (the
plain version on the CPU), its backward ``antialias.aa_snake_plain_vjp`` in
plain PyTorch, the exact VJP of the plain version's function.  It saves x
and the exp'ed alpha and beta only, as the JAX package's ``custom_vjp`` of
``fused_aa_snake`` saves its primals; ``exp``'s chain rule stays outside, with
autograd.  The JAX package's backward is XLA, not a Pallas kernel, so there is
no backward kernel to port; one waits until its share of the training step
calls for it.  ``aa_snake_kernel`` itself stays forward only.

In bf16 training x, alpha and beta all arrive in bf16 (the parameters exp'ed
in bf16, ``antialias.snake_params``): the forward launches K1's bf16
route, and the backward accumulates in fp32 and returns bf16 gradients (see
``aa_snake_plain_vjp``).  A failure to build or launch raises; nothing falls
back to the plain version on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vocoder_tpu_torch.ops import build
from vocoder_tpu_torch.ops.antialias import aa_snake_plain, aa_snake_plain_vjp, snake_params

# Operations per output sample, for the roofline bound, an FMA counted as two.
# The plain version's order (aa::Exact, K2's prologue): two 6-tap branch FIRs
# (2 x 13: six products, five adds, the doubling), two snakes (2 x 27: the
# argument, the Cody-Waite reduction, the degree-6 Horner cosine, the scale
# and the add) and the 12-tap decimating FIR (24).
EXACT_FLOPS_PER_SAMPLE = 104
# K1's FMA form (aa::Fma): the branch FIRs on doubled taps (2 x 11: a product
# and five FMAs), two snakes (2 x 21: the argument 1, the rounding of u / 2 pi
# by a shifter 3, the reduction in two FMAs 4, r^2 1, the Horner cosine, its
# constant term and the scale folded per channel, in five FMAs 10, and the add
# in one FMA 2) and the 12-tap decimating FIR (12 FMAs, 24): 48 fp32
# instructions.
FLOPS_PER_SAMPLE = 88

_C_VOID = ctypes.c_void_p
_C_INT = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The K1 library with its C entries' types set, once."""
    lib = build.load("aa_snake")
    fn = lib.aa_snake_fwd
    fn.argtypes = [_C_VOID, _C_VOID, _C_INT, _C_VOID, _C_VOID, _C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_VOID, _C_VOID]
    fn.restype = _C_INT
    lib.error_string.argtypes = [_C_INT]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def aa_snake_kernel(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor | None, logscale: bool,
                    lengths=None) -> torch.Tensor:
    """Launch K1 on a CUDA (B, C, T) tensor; alpha/beta are the raw (C,) parameters, ``lengths``
    the (B,) item lengths of a padded batch (None: every item is T long)."""
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"aa_snake: expected a contiguous (B, C, T) tensor, got shape {tuple(x.shape)}")
    b, c, t = x.shape
    beta = alpha if beta is None else beta
    for name, p in (("alpha", alpha), ("beta", beta)):
        if p.shape != (c,) or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"aa_snake: {name} must be a contiguous ({c},) tensor on {x.device}")
    if alpha.dtype != beta.dtype:
        raise TypeError("aa_snake: alpha and beta must share a dtype")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, alpha, beta)):
        raise RuntimeError("aa_snake: the kernel is forward only; run it under torch.inference_mode()")
    lens = build.lengths_arg(lengths, x)
    lib = _lib()
    z = torch.empty_like(x)
    err = lib.aa_snake_fwd(
        x.data_ptr(), z.data_ptr(), build.dtype_code(x, "aa_snake x"),
        alpha.data_ptr(), beta.data_ptr(), build.dtype_code(alpha, "aa_snake alpha"),
        int(logscale), b, c, t, build.ptr(lens), build.stream_ptr(x.device),
    )
    if err:
        raise RuntimeError(f"aa_snake: launch failed: {lib.error_string(err).decode()}")
    aa_snake.launches += 1
    return z


class AASnakeFunction(torch.autograd.Function):
    """The anti-aliased Snake under autograd: (x (B, C, T), alpha, beta) with alpha/beta the (C,)
    parameters already exp'ed.  Forward: K1 on a CUDA tensor, the plain version on the CPU.
    Backward: ``aa_snake_plain_vjp``, from x, alpha and beta alone."""

    @staticmethod
    def forward(ctx, x, alpha, beta):
        ctx.save_for_backward(x, alpha, beta)
        if x.is_cuda:
            return aa_snake_kernel(x, alpha, beta, False)
        if x.device.type != "cpu":
            raise RuntimeError(f"aa_snake: no kernel for device {x.device}")
        return aa_snake_plain(x, alpha, beta)

    @staticmethod
    def backward(ctx, gz):
        with torch.profiler.record_function("aa_snake_backward"):
            return aa_snake_plain_vjp(*ctx.saved_tensors, gz)


def aa_snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor | None, logscale: bool,
             lengths=None) -> torch.Tensor:
    """Anti-aliased Snake on (B, C, T), each item clamped at its length where ``lengths`` is given:
    the kernel for CUDA, the plain version for the CPU; ``AASnakeFunction`` under autograd."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, alpha, beta)):
        if lengths is not None:
            raise NotImplementedError("aa_snake: per-item lengths under autograd are not ported")
        return AASnakeFunction.apply(x.contiguous(), *snake_params(alpha, beta, logscale))
    if x.is_cuda:  # a channel shard of tensor parallelism may come as a view: the kernel takes a copy
        return aa_snake_kernel(x.contiguous(), alpha, beta, logscale, lengths)
    if x.device.type != "cpu":
        raise RuntimeError(f"aa_snake: no kernel for device {x.device}")
    return aa_snake_plain(x, *snake_params(alpha, beta, logscale), lengths)


aa_snake.launches = 0
