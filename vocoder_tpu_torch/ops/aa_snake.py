"""K1: the anti-aliased Snake, as a hand-written CUDA kernel beside its plain version.

Replaces the Pallas kernel ``vocoder_tpu/ops/pallas/aa_snake.py::_kernel``
(``pallas_call`` in ``_interior``, wrapped by ``fused_aa_snake``).  The CUDA
source is ``csrc/aa_snake.cu`` with the device functions in
``csrc/aa_snake.cuh``, which the AMP conv kernel shares.  On an H100 it is
bound by its fp32 operations (about 104 per output sample, most of them the
sin polynomial's FMAs) rather than by its bytes (one read and one write per
sample); it keeps the 2x-rate signal in shared memory and makes the sequence
edges exact by index clamping, so no edge splice follows it.

``aa_snake`` takes a CPU tensor to the plain version
(``antialias.aa_snake_plain``) and launches the kernel for a CUDA tensor, or
raises.  ``aa_snake.launches`` counts kernel launches.  The backward kernel
waits for the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from vocoder_tpu_torch.ops import build
from vocoder_tpu_torch.ops.antialias import aa_snake_plain, snake_params

# Operations per output sample, for the roofline bound: two 6-tap branch
# FIRs (2 x 13), two snakes (2 x 27: the argument, the Cody-Waite reduction,
# the degree-6 Horner cosine and the add) and the 12-tap decimating FIR (24).
FLOPS_PER_SAMPLE = 104

_C_VOID = ctypes.c_void_p
_C_INT = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("aa_snake")
    fn = lib.aa_snake_fwd
    fn.argtypes = [_C_VOID, _C_VOID, _C_INT, _C_VOID, _C_VOID, _C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_VOID]
    fn.restype = _C_INT
    lib.error_string.argtypes = [_C_INT]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def aa_snake_kernel(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor | None, logscale: bool) -> torch.Tensor:
    """Launch K1 on a CUDA (B, C, T) tensor; alpha/beta are the raw (C,) parameters."""
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
    lib = _lib()
    z = torch.empty_like(x)
    err = lib.aa_snake_fwd(
        x.data_ptr(), z.data_ptr(), build.dtype_code(x, "aa_snake x"),
        alpha.data_ptr(), beta.data_ptr(), build.dtype_code(alpha, "aa_snake alpha"),
        int(logscale), b, c, t, build.stream_ptr(x.device),
    )
    if err:
        raise RuntimeError(f"aa_snake: launch failed: {lib.error_string(err).decode()}")
    aa_snake.launches += 1
    return z


def aa_snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor | None, logscale: bool) -> torch.Tensor:
    """Anti-aliased Snake on (B, C, T): the kernel for CUDA, the plain version for the CPU."""
    if x.is_cuda:
        return aa_snake_kernel(x, alpha, beta, logscale)
    if x.device.type != "cpu":
        raise RuntimeError(f"aa_snake: no kernel for device {x.device}")
    return aa_snake_plain(x, *snake_params(alpha, beta, logscale))


aa_snake.launches = 0
