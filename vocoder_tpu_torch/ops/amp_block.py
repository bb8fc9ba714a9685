"""K2: a whole BigVGAN AMP stage, as a hand-written CUDA kernel beside its plain version.

Replaces the Pallas kernel ``vocoder_tpu/ops/pallas/amp_block.py::_kernel``
(``pallas_call`` in ``amp_stage_fused``), which evaluated a whole stage per
TPU VMEM tile: for each block (kernel size k, dilations ds) and each d in ds,
aa-snake -> conv k dilation d -> aa-snake -> conv k -> residual add, then the
mean over the blocks.  On Hopper the stage runs as one fused kernel per conv:
each launch evaluates ``conv(aa_snake(x)) + bias`` with the aa-snake computed
on chip, plus the residual add or the block-sum epilogue.  The
residual stream and the stage sum stay in fp32 between launches; the stage
output is cast to x's dtype once.  That is ``2 * sum(len(ds))`` launches a
stage, 18 for BigVGAN's (3, 7, 11) x (1, 3, 5).

One kernel, ``csrc/amp_conv_mma.cu``, runs the convs on the tensor cores
(``mma.sync``, fp32 sums); the model's dtype picks its operand type:
- bf16 parameters: the conv inputs rounded to bf16 once, as the TPU kernel
  rounds its matmul operands to ``mm_dtype = x.dtype``.  x may be bf16 or fp32.
- fp32 parameters: 3xTF32.  Each fp32 operand splits into tf32 ``hi`` and
  ``lo`` and each product is ``lo·hi + hi·lo + hi·hi``, fp32-grade, as the
  JAX package's fp32 convs run at ``Precision.HIGHEST``.  x must be fp32.
Both take C <= 256, every BigVGAN preset's widest stage.  The convs bound the
kernel (three tf32 passes at 495 TFLOP/s in fp32, one bf16 pass at 989 in
bf16) beside the aa-snake prologue on the fp32 CUDA cores; the kernel computes
the aa-snake once per tile and streams each conv's packed weights through a
``cp.async`` ring (the source's header has the design).

The fp32 route has a second kernel, ``csrc/amp_conv_wgmma.cu``: the same prologue
and epilogue around a main loop on ``wgmma`` fed by TMA, with each conv's weights
split once into tf32 halves (``tf32_split``, K3's rule) in the stage's plan.  It
takes C in ``WGMMA_TIME_TILES`` at the shapes where it was measured the faster
(``takes_wgmma``: C, B, T and the SM count, before any launch); the ``mma.sync``
kernel keeps the other widths and C = 256 at the short grids of short b1 requests.

With per-item ``lengths`` (a right-padded batch, BigVGAN's ``frame_lengths``
scaled to the stage) every launch clamps each item's aa-snake at its own
length and writes 0 past it, so each row equals that item's stage alone
(``vocoder_tpu/models/bigvgan.py::_amp_apply`` with ``lens``); the lengths
stay on the card.

Each conv's kernel arguments (the packed weights and the parameter
pointers) are built once per model state into a ``StagePlan``, kept outside
the modules (``stage_plans``, ``utils/weight_cache.py``); ``state_dict()``
never sees it.  A launch is then one ctypes call.

``amp_stage`` takes a CPU tensor to ``amp_stage_plain`` and launches the
kernel for a CUDA tensor, or raises.  ``amp_stage.launches`` counts
launches of the fp32 (3xTF32) route, of which ``amp_stage.wgmma_launches``
took the wgmma kernel; ``amp_stage.mma_launches`` counts those of the bf16
route.  Forward only, as on the TPU.

``kernel_takes`` says, from the width alone and before any launch, whether
the kernel takes a stage, as the JAX package's ``amp_stage_supported`` does;
the generator runs a stage it does not take (and every stage in training)
block by block, and counts it in ``BigVGAN.blockwise_stages``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from vocoder_tpu_torch.nn import get_padding, length_mask
from vocoder_tpu_torch.ops import build
from vocoder_tpu_torch.ops.antialias import aa_snake_plain, item_lengths, snake_params
from vocoder_tpu_torch.ops.linear_3xtf32 import tf32_split
from vocoder_tpu_torch.utils.weight_cache import WeightCache

_C_VOID = ctypes.c_void_p
_C_INT = ctypes.c_int

LIB = "amp_conv_mma"  # csrc/amp_conv_mma.cu
WGMMA_LIB = "amp_conv_wgmma"  # csrc/amp_conv_wgmma.cu: the fp32 route's wgmma kernel
# The wgmma kernel's time tile for each channel class it takes (the source's with_config).
WGMMA_TIME_TILES = {64: 128, 128: 128, 256: 64}
# The share of the card's SMs that a stage's wgmma grid (one block a time tile and item) must pass for the
# wgmma kernel to take it.  Measured at b1 on the H100 (132 SMs, 8 to 264 blocks): at C = 64 and 128 it
# beat the mma.sync kernel at every grid (0.67-0.72x); at C = 256 it lost by 5-11% up to 32 blocks, where
# the mma.sync kernel's 32 x 128 tiles still run in one wave, and won from 48 on (0.30-0.58x).
WGMMA_MIN_SM_SHARE = {64: 0.0, 128: 0.0, 256: 0.25}
# The kernel's route (operand type of the convs) for each parameter dtype.
ROUTES = {torch.float32: "3xtf32", torch.bfloat16: "bf16"}
MMA_MAX_CHANNELS = 256


class ConvParams(ctypes.Structure):
    """``AmpConvParams`` of ``csrc/amp_conv.cuh``: what stays fixed for one conv of a model."""

    _fields_ = [
        ("w", _C_VOID), ("bias", _C_VOID), ("alpha", _C_VOID), ("beta", _C_VOID),
        ("param_dtype", _C_INT), ("logscale", _C_INT), ("C", _C_INT), ("K", _C_INT), ("dil", _C_INT),
        ("n_blocks", ctypes.c_float),
    ]


class TmaMap(ctypes.Structure):
    """A ``CUtensorMap`` (128 opaque bytes): the wgmma kernel's TMA map of one conv's tf32 halves."""

    _fields_ = [("opaque", ctypes.c_uint64 * 16)]


def _lib() -> ctypes.CDLL:
    lib = build.load(LIB)
    fn = lib.amp_conv_fwd
    if fn.argtypes is None:
        fn.argtypes = [
            _C_VOID, _C_VOID, _C_INT, _C_INT, _C_INT,  # params, x, x_dtype, B, T
            _C_VOID, _C_INT, _C_VOID, _C_VOID, _C_VOID,  # res, res_dtype, out, acc_in, acc_out
            _C_VOID, _C_INT, _C_VOID, _C_VOID,  # fin, fin_dtype, lens, stream
        ]
        fn.restype = _C_INT
        lib.error_string.argtypes = [_C_INT]
        lib.error_string.restype = ctypes.c_char_p
        lib.amp_conv_launch_shape.argtypes = [_C_INT, _C_INT, _C_INT, _C_INT, ctypes.POINTER(_C_INT)]
        lib.amp_conv_launch_shape.restype = _C_INT
    return lib


def bind_wgmma(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/amp_conv_wgmma.cu``) with its entries' argument types set."""
    lib.amp_conv_wgmma_fwd.argtypes = [
        _C_VOID, _C_VOID, _C_VOID, _C_INT, _C_INT, _C_INT,  # params, map, x, x_dtype, B, T
        _C_VOID, _C_INT, _C_VOID, _C_VOID, _C_VOID,  # res, res_dtype, out, acc_in, acc_out
        _C_VOID, _C_INT, _C_VOID, _C_VOID,  # fin, fin_dtype, lens, stream
    ]
    lib.amp_conv_wgmma_fwd.restype = _C_INT
    lib.amp_conv_wgmma_map.argtypes = [_C_VOID, _C_INT, _C_INT, _C_INT, _C_VOID]
    lib.amp_conv_wgmma_map.restype = _C_INT
    lib.amp_conv_wgmma_launch_shape.argtypes = [_C_INT, _C_INT, _C_INT, ctypes.POINTER(_C_INT)]
    lib.amp_conv_wgmma_launch_shape.restype = _C_INT
    lib.error_string.argtypes = [_C_INT]
    lib.error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _wgmma_lib() -> ctypes.CDLL:
    return bind_wgmma(build.load(WGMMA_LIB))


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def wgmma_wins(c: int, b: int, t: int, sms: int) -> bool:
    """Whether the wgmma kernel is the faster at (C, B, T) on a card of ``sms`` SMs: C is one of its
    channel classes and its grid passes that class's ``WGMMA_MIN_SM_SHARE`` of the SMs."""
    tile = WGMMA_TIME_TILES.get(c)
    return tile is not None and b * -(-t // tile) > WGMMA_MIN_SM_SHARE[c] * sms


def takes_wgmma(plan: StagePlan, b: int, t: int) -> bool:
    """Whether a stage of ``plan`` at (B, T) runs on the wgmma kernel: an fp32 plan on the card whose every
    conv it takes (``plan.maps``), at a shape where it wins (``wgmma_wins``)."""
    return bool(plan.maps) and wgmma_wins(plan.channels, b, t, _sm_count(plan.device.index))


def launch_shape(dtype: torch.dtype, c: int, b: int, t: int) -> tuple[int, int]:
    """(time tile, blocks) of one kernel launch for a ``dtype`` model at (C, B, T) on the current card: the
    wgmma kernel's where an fp32 stage takes it (BigVGAN's kernel sizes and dilations), else the
    mma.sync kernel's."""
    shape = (_C_INT * 2)()
    if dtype == torch.float32 and wgmma_wins(c, b, t, _sm_count(torch.cuda.current_device())):
        if _wgmma_lib().amp_conv_wgmma_launch_shape(c, b, t, shape):
            raise ValueError(f"amp_stage: no wgmma launch at C = {c}, B = {b}, T = {t}")
        return shape[0], shape[1]
    err = _lib().amp_conv_launch_shape(build.DTYPE_CODES[dtype], c, b, t, shape)
    if err:
        raise ValueError(f"amp_stage: no launch at C = {c}, B = {b}, T = {t}")
    return shape[0], shape[1]


def kernel_takes(channels: int) -> bool:
    """Whether K2 takes a stage of this width: C <= 256 and C % 16 == 0."""
    return channels <= MMA_MAX_CHANNELS and channels % 16 == 0


def _snake(act) -> tuple[torch.Tensor, torch.Tensor | None]:
    return act.activation.alpha, act.activation.beta


def amp_stage_plain(blocks, x: torch.Tensor, logscale: bool, lengths=None, conv=F.conv1d) -> torch.Tensor:
    """mean_k(AMP block k (x)) with the plain aa-snake and ``conv`` (F.conv1d), fp32 inside.

    Each conv input is rounded to x's dtype first, as the TPU kernel rounds its
    matmul operands to ``mm_dtype = x.dtype``; for fp32 x that changes nothing.
    ``lengths`` (B,): each item's aa-snake is clamped at its length and every conv
    output masked past it, as the JAX package's ``_amp_apply`` with ``lens``, and
    so is the stage output.  ``conv`` is a test hook: the CPU tests pass an
    emulation of the fp32 route's 3xTF32 products through it."""
    xf = x.float()
    lens = None
    if lengths is not None:
        lens = torch.tensor(item_lengths(lengths, x.shape[0], x.shape[-1]), device=x.device)

    def act(h, a):
        return aa_snake_plain(h, *snake_params(*_snake(a), logscale), lens).to(x.dtype).float()

    outs = []
    for blk in blocks:
        h = xf
        k = blk.kernel_size
        for i, (c1, c2, d) in enumerate(zip(blk.convs1, blk.convs2, blk.dilations)):
            a1, a2 = blk.activations[2 * i], blk.activations[2 * i + 1]
            t = conv(act(h, a1), c1.weight.float(), c1.bias.float(), padding=get_padding(k, d), dilation=d)
            t = length_mask(t, lens)
            t = conv(act(t, a2), c2.weight.float(), c2.bias.float(), padding=get_padding(k))
            h = h + length_mask(t, lens)
        outs.append(h)
    return length_mask(sum(outs) / len(outs), lens).to(x.dtype)


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, K) -> (K, C_out, C_in) contiguous, pack[j, o, i] = w[o, i, j], dtype kept: the
    kernel's B operand, each (tap, channel-chunk) a run of contiguous rows."""
    return w.detach().permute(2, 0, 1).contiguous()


@dataclasses.dataclass
class StagePlan:
    """The launch arguments of one stage's convs, in launch order, for one model state."""

    dtype: torch.dtype
    device: torch.device
    channels: int
    route: str  # a value of ROUTES
    params: list[ConvParams]
    addrs: list[int]  # ctypes.addressof of each ConvParams
    weights: list[torch.Tensor]  # what the ConvParams point to, kept alive
    # fp32 at C in WGMMA_TIME_TILES: each conv's (2, K, C, C) pack of tf32 halves, hi then lo, of its
    # packed weight (pack_conv_weight), the wgmma kernel's B operand; else empty.
    halves: list[torch.Tensor]
    # On the card, each conv's TMA map of its halves, where the wgmma kernel takes every conv; else empty.
    maps: list[TmaMap]
    map_addrs: list[int]


stage_plans = WeightCache()  # first block -> StagePlan


def stage_plan(blocks, logscale: bool) -> StagePlan:
    """These blocks' ``StagePlan``, kept in ``stage_plans`` by the rule of ``utils/weight_cache.py``."""
    return stage_plans.get(blocks[0], blocks, lambda: _build_plan(blocks, logscale), logscale)


def _build_plan(blocks, logscale: bool) -> StagePlan:
    first = blocks[0].convs1[0].weight
    dtype, device, c = first.dtype, first.device, first.shape[0]
    if dtype not in ROUTES:
        raise TypeError(f"amp_stage: no kernel for {dtype} parameters (float32 or bfloat16)")
    if c > MMA_MAX_CHANNELS:
        raise ValueError(f"amp_stage: the kernel takes C <= {MMA_MAX_CHANNELS}, got C = {c}")
    params, weights, halves = [], [], []
    split = dtype == torch.float32 and c in WGMMA_TIME_TILES
    for blk in blocks:
        k = blk.kernel_size
        for i, (c1, c2, d) in enumerate(zip(blk.convs1, blk.convs2, blk.dilations)):
            for act, conv, dil in ((blk.activations[2 * i], c1, d), (blk.activations[2 * i + 1], c2, 1)):
                alpha, beta = _snake(act)
                beta = alpha if beta is None else beta
                w = conv.weight.detach()
                vecs = [t.detach() for t in (conv.bias, alpha, beta)]
                if w.shape != (c, c, k) or any(t.shape != (c,) or not t.is_contiguous() for t in vecs):
                    raise ValueError(f"amp_stage: conv weight {tuple(w.shape)} does not fit C = {c}, k = {k}")
                if any(t.dtype != dtype or t.device != device for t in (w, *vecs)):
                    raise ValueError("amp_stage: every parameter of a stage needs one dtype and one device")
                w = pack_conv_weight(w)
                params.append(ConvParams(w.data_ptr(), *(t.data_ptr() for t in vecs), build.DTYPE_CODES[dtype],
                                         int(logscale), c, k, dil, float(len(blocks))))
                weights += [w, *vecs]
                if split:
                    halves.append(torch.stack(tf32_split(w)))
    maps = _wgmma_maps(params, halves) if halves and device.type == "cuda" else []
    return StagePlan(dtype, device, c, ROUTES[dtype], params, [ctypes.addressof(p) for p in params], weights,
                     halves, maps, [ctypes.addressof(m) for m in maps])


def _wgmma_maps(params: list[ConvParams], halves: list[torch.Tensor]) -> list[TmaMap]:
    """Each conv's TMA map of its halves, or [] where the wgmma kernel does not take one of them (an act
    tile and ring that would not fit in shared memory at its kernel size and dilation).  Raises where a
    map cannot be made."""
    lib, maps = _wgmma_lib(), []
    for p, h in zip(params, halves):
        m = TmaMap()
        err = lib.amp_conv_wgmma_map(h.data_ptr(), p.C, p.K, p.dil, ctypes.byref(m))
        if err == -1:
            return []
        if err:
            raise RuntimeError(f"amp_stage: no TMA map for the wgmma kernel: {lib.error_string(err).decode()}")
        maps.append(m)
    return maps


def amp_stage_kernel(blocks, x: torch.Tensor, logscale: bool, lengths=None) -> torch.Tensor:
    """The stage on a CUDA (B, C, T) tensor: one K2 launch per conv; ``lengths``: the (B,) item
    lengths of a padded batch (None: every item is T long)."""
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"amp_stage: expected a contiguous (B, C, T) tensor, got shape {tuple(x.shape)}")
    if x.shape[1] % 16:
        raise ValueError(f"amp_stage: the kernel needs C % 16 == 0, got C = {x.shape[1]}")
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for b in blocks for p in b.parameters())):
        raise RuntimeError("amp_stage: the kernels are forward only; run them under torch.inference_mode()")
    plan = stage_plan(blocks, logscale)
    if plan.channels != x.shape[1] or plan.device != x.device:
        raise ValueError(f"amp_stage: a {plan.channels}-channel model on {plan.device} cannot take x "
                         f"{tuple(x.shape)} on {x.device}")
    if x.dtype == torch.bfloat16 and plan.dtype != torch.bfloat16:
        raise ValueError("amp_stage: a bf16 input needs a bf16 model; cast the model with the input")
    xd = build.dtype_code(x, "amp_stage x")
    lens = build.lengths_arg(lengths, x)
    lens_p = build.ptr(lens)
    fp32 = plan.dtype == torch.float32
    b, _, t = x.shape
    wgmma = takes_wgmma(plan, b, t)
    lib = _wgmma_lib() if wgmma else _lib()
    fn = lib.amp_conv_wgmma_fwd if wgmma else lib.amp_conv_fwd
    maps = iter(plan.map_addrs)
    n_k = len(blocks)
    # fp32 scratch: the residual stream of the current block, the first conv of the
    # current pair and the sum of the finished blocks, in one allocation.
    scratch = torch.empty((3 if n_k > 1 else 2, *x.shape), device=x.device, dtype=torch.float32)
    z = torch.empty_like(x)
    step = x.numel() * 4
    xp, rp, zp = x.data_ptr(), scratch.data_ptr(), z.data_ptr()
    yp, acc = rp + step, (rp + 2 * step if n_k > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    addrs = iter(plan.addrs)

    def launch(src, src_dt, res_p, res_dt, out=None, acc_in=None, acc_out=None, fin=None):
        args = (src, src_dt, b, t, res_p, res_dt, out, acc_in, acc_out, fin, xd, lens_p, stream)
        err = fn(next(addrs), next(maps), *args) if wgmma else fn(next(addrs), *args)
        if err:
            raise RuntimeError(f"amp_stage: launch failed: {lib.error_string(err).decode()}")
        if fp32:
            amp_stage.launches += 1
            amp_stage.wgmma_launches += wgmma
        else:
            amp_stage.mma_launches += 1

    for kb, blk in enumerate(blocks):
        cur, cur_dt = xp, xd
        n_d = len(blk.dilations)
        for i in range(n_d):
            launch(cur, cur_dt, None, 0, out=yp)
            if i + 1 < n_d:  # residual add, in place once cur is the fp32 stream
                launch(yp, 0, cur, cur_dt, out=rp)
                cur, cur_dt = rp, 0
            elif kb + 1 < n_k:  # block done: add it to the stage sum
                launch(yp, 0, cur, cur_dt, acc_in=acc if kb else None, acc_out=acc)
            else:  # stage done: (sum + last block) / n_k, cast to x's dtype
                launch(yp, 0, cur, cur_dt, acc_in=acc if kb else None, fin=zp)
    return z


def amp_stage(blocks, x: torch.Tensor, logscale: bool, lengths=None) -> torch.Tensor:
    """mean over AMP blocks of (B, C, T), each item masked at its length where ``lengths`` is given:
    the kernels for CUDA, the plain version for the CPU."""
    if x.is_cuda:
        return amp_stage_kernel(blocks, x, logscale, lengths)
    if x.device.type != "cpu":
        raise RuntimeError(f"amp_stage: no kernel for device {x.device}")
    return amp_stage_plain(blocks, x, logscale, lengths)


amp_stage.launches = 0
amp_stage.wgmma_launches = 0
amp_stage.mma_launches = 0
