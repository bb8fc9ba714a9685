"""K2: a whole BigVGAN AMP stage, as hand-written CUDA kernels beside its plain version.

Replaces the Pallas kernel ``vocoder_tpu/ops/pallas/amp_block.py::_kernel``
(``pallas_call`` in ``amp_stage_fused``), which evaluated a whole stage per
TPU VMEM tile: for each block (kernel size k, dilations ds) and each d in ds,
aa-snake -> conv k dilation d -> aa-snake -> conv k -> residual add, then the
mean over the blocks.  On Hopper the stage runs as one fused kernel per conv
(``csrc/amp_stage.cu``): each launch evaluates ``conv(aa_snake(x)) + bias``
with the aa-snake computed in shared memory, plus the residual add or the
block-sum epilogue.  The residual stream and the stage sum stay in fp32
between launches; the stage output is cast to x's dtype once.  That is
``2 * sum(len(ds))`` launches a stage, 18 for BigVGAN's (3, 7, 11) x
(1, 3, 5).  The convs cost 2 C K operations per output and channel, which
bounds the kernel by arithmetic, not bytes; it is a plain fp32-FMA kernel
for now.

``amp_stage`` takes a CPU tensor to ``amp_stage_plain`` and launches the
kernels for a CUDA tensor, or raises.  ``amp_stage.launches`` counts kernel
launches.  Forward only, as on the TPU.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vocoder_tpu_torch.nn import get_padding
from vocoder_tpu_torch.ops import build
from vocoder_tpu_torch.ops.antialias import aa_snake_plain, snake_params

_C_VOID = ctypes.c_void_p
_C_INT = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("amp_stage")
    fn = lib.amp_conv_fwd
    fn.argtypes = [
        _C_VOID, _C_INT,  # x, x_dtype
        _C_VOID, _C_VOID, _C_INT,  # alpha, beta, logscale
        _C_VOID, _C_VOID, _C_INT,  # w, bias, w_dtype
        _C_INT, _C_INT, _C_INT, _C_INT, _C_INT,  # B, C, T, K, dil
        _C_VOID, _C_INT,  # res, res_dtype
        _C_VOID, _C_VOID, _C_VOID,  # out, acc_in, acc_out
        _C_VOID, _C_INT, ctypes.c_float,  # fin, fin_dtype, n_blocks
        _C_VOID,  # stream
    ]
    fn.restype = _C_INT
    lib.error_string.argtypes = [_C_INT]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def _snake(act) -> tuple[torch.Tensor, torch.Tensor | None]:
    return act.activation.alpha, act.activation.beta


def amp_stage_plain(blocks, x: torch.Tensor, logscale: bool) -> torch.Tensor:
    """mean_k(AMP block k (x)) in fp32 with the plain aa-snake and F.conv1d."""
    xf = x.float()
    outs = []
    for blk in blocks:
        h = xf
        k = blk.kernel_size
        for i, (c1, c2, d) in enumerate(zip(blk.convs1, blk.convs2, blk.dilations)):
            a1, a2 = blk.activations[2 * i], blk.activations[2 * i + 1]
            t = aa_snake_plain(h, *snake_params(*_snake(a1), logscale))
            t = F.conv1d(t, c1.weight.float(), c1.bias.float(), padding=get_padding(k, d), dilation=d)
            t = aa_snake_plain(t, *snake_params(*_snake(a2), logscale))
            t = F.conv1d(t, c2.weight.float(), c2.bias.float(), padding=get_padding(k))
            h = h + t
        outs.append(h)
    return (sum(outs) / len(outs)).to(x.dtype)


def _conv(lib, x, act, conv, k: int, d: int, logscale: bool, *, res=None, out=None, acc_in=None, acc_out=None,
          fin=None, n_blocks: int = 1) -> None:
    alpha, beta = _snake(act)
    beta = alpha if beta is None else beta
    w = conv.weight.contiguous()
    b, c, t = x.shape
    params = (alpha, beta, w, conv.bias)
    if w.shape != (c, c, k) or any(p.dtype != w.dtype or p.device != x.device for p in params):
        raise ValueError(f"amp_stage: conv weight {tuple(w.shape)} / parameter dtypes do not fit x {tuple(x.shape)}")
    if x.dtype == torch.bfloat16 and w.dtype != torch.bfloat16:
        raise ValueError("amp_stage: a bf16 input needs a bf16 model; cast the model with the input")
    err = lib.amp_conv_fwd(
        x.data_ptr(), build.dtype_code(x, "amp_stage x"),
        alpha.data_ptr(), beta.data_ptr(), int(logscale),
        w.data_ptr(), conv.bias.data_ptr(), build.dtype_code(w, "amp_stage weight"),
        b, c, t, k, d,
        None if res is None else res.data_ptr(), 0 if res is None else build.dtype_code(res, "amp_stage res"),
        None if out is None else out.data_ptr(),
        None if acc_in is None else acc_in.data_ptr(),
        None if acc_out is None else acc_out.data_ptr(),
        None if fin is None else fin.data_ptr(), 0 if fin is None else build.dtype_code(fin, "amp_stage out"),
        float(n_blocks), build.stream_ptr(x.device),
    )
    if err:
        raise RuntimeError(f"amp_stage: launch failed: {lib.error_string(err).decode()}")
    amp_stage.launches += 1


def amp_stage_kernel(blocks, x: torch.Tensor, logscale: bool) -> torch.Tensor:
    """The stage on a CUDA (B, C, T) tensor: one K2 launch per conv."""
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"amp_stage: expected a contiguous (B, C, T) tensor, got shape {tuple(x.shape)}")
    if x.shape[1] % 16:
        raise ValueError(f"amp_stage: the kernel needs C % 16 == 0, got C = {x.shape[1]}")
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for b in blocks for p in b.parameters())):
        raise RuntimeError("amp_stage: the kernels are forward only; run them under torch.inference_mode()")
    lib = _lib()
    n_k = len(blocks)
    f32 = dict(device=x.device, dtype=torch.float32)
    res = torch.empty(x.shape, **f32)  # residual stream of the current block
    y = torch.empty(x.shape, **f32)  # first conv of the current pair
    acc = torch.empty(x.shape, **f32) if n_k > 1 else None  # sum of finished blocks
    z = torch.empty_like(x)
    for kb, blk in enumerate(blocks):
        cur = x
        k = blk.kernel_size
        n_d = len(blk.dilations)
        for i, (c1, c2, d) in enumerate(zip(blk.convs1, blk.convs2, blk.dilations)):
            a1, a2 = blk.activations[2 * i], blk.activations[2 * i + 1]
            _conv(lib, cur, a1, c1, k, d, logscale, out=y)
            if i + 1 < n_d:  # residual add, in place once cur is the fp32 stream
                _conv(lib, y, a2, c2, k, 1, logscale, res=cur, out=res)
                cur = res
            elif kb + 1 < n_k:  # block done: add it to the stage sum
                _conv(lib, y, a2, c2, k, 1, logscale, res=cur, acc_in=acc if kb else None, acc_out=acc)
            else:  # stage done: (sum + last block) / n_k, cast to x's dtype
                _conv(lib, y, a2, c2, k, 1, logscale, res=cur, acc_in=acc if kb else None, fin=z, n_blocks=n_k)
    return z


def amp_stage(blocks, x: torch.Tensor, logscale: bool) -> torch.Tensor:
    """mean over AMP blocks of (B, C, T): the kernels for CUDA, the plain version for the CPU."""
    if x.is_cuda:
        return amp_stage_kernel(blocks, x, logscale)
    if x.device.type != "cpu":
        raise RuntimeError(f"amp_stage: no kernel for device {x.device}")
    return amp_stage_plain(blocks, x, logscale)


amp_stage.launches = 0
