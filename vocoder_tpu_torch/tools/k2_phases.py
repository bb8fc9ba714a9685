"""Where K2's time goes: each phase of one route cut out in turn, on the card.

    python -m vocoder_tpu_torch.tools.k2_phases [--dtype bf16|fp32]   # from the repository root; one CUDA card

Builds copies of K2's sources in which one phase does nothing (the aa-snake
prologue, the tensor-core main loop, or the epilogue's reads and writes of
device memory; in fp32 also the operand split, left out or written as
``cvt.rna``), times the five AMP stages of the 44.1 kHz BigVGAN (F = 256
frames, random weights from seed 0) in the model dtype ``--dtype`` (bf16 by
default; fp32 takes the 3xTF32 route) through each at b1 and b16 with CUDA
events, and prints one JSON line per variant.  In fp32 each variant cuts the
same phase from both kernels, ``csrc/amp_conv_mma.cu`` (``CUTS``) and the wgmma
kernel ``csrc/amp_conv_wgmma.cu`` (``WGMMA_CUTS``), so every stage runs the cut
whichever kernel the shape rule gives it.  A phase's cost is the full time
minus the time without it; phases overlap across blocks, so the costs need
not add up to the full time.  The outputs of the cut variants are wrong by
design and are not checked.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from vocoder_tpu_torch.config import build_task_config
from vocoder_tpu_torch.models.bigvgan import BigVGAN, random_state_dict
from vocoder_tpu_torch.nn import fold_weight_norm
from vocoder_tpu_torch.ops import build
from vocoder_tpu_torch.ops import amp_block
from vocoder_tpu_torch.ops.amp_block import LIB, WGMMA_LIB, amp_stage_kernel
from vocoder_tpu_torch.tools.timing import build_variants, card_line, cuda_ms, edit

# Each cut: (text in the source, what replaces it, the dtypes it applies to).
_SPLIT = """      f.hi[i] = tf32(r[i]);
      f.lo[i] = tf32(__float_as_uint(__fsub_rn(__uint_as_float(r[i]), __uint_as_float(f.hi[i]))));"""
CUTS = {
    "no_prologue": ("  if (threadIdx.x < C * n_seg) {", "  if (false) {", ("bf16", "fp32")),
    "no_mma": ("for (int q = 0; q < n_chunks; ++q) {", "for (int q = 0; q < 0; ++q) {", ("bf16", "fp32")),
    "no_epilogue_io": ("for (int idx = threadIdx.x; idx < n_out * kQuads; idx += kThreads) {",
                       "for (int idx = threadIdx.x; idx < 0; idx += kThreads) {", ("bf16", "fp32")),
    # The 3xTF32 operand split: left out (each fp32 pattern goes to the MMAs as it is), or written
    # as the cvt.rna.tf32.f32 instructions whose rounding the integer split reproduces.
    "no_split": (_SPLIT, "      f.hi[i] = f.lo[i] = r[i];", ("fp32",)),
    "cvt_split": (_SPLIT, """      asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(f.hi[i]) : "f"(__uint_as_float(r[i])));
      const float rest = __fsub_rn(__uint_as_float(r[i]), __uint_as_float(f.hi[i]));
      asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(f.lo[i]) : "f"(rest));""", ("fp32",)),
}

# The same cuts in the wgmma kernel (fp32 only): (text in csrc/amp_conv_wgmma.cu, what replaces it).
_WG_SPLIT = """          hi[kk][i] = tf32_rna(r[i]);
          lo[kk][i] = tf32_rna(__float_as_uint(__fsub_rn(__uint_as_float(r[i]), __uint_as_float(hi[kk][i]))));"""
WGMMA_CUTS = {
    "no_prologue": ("  if (threadIdx.x < C * kSeg) {", "  if (false) {"),
    "no_mma": ("n_chunks = K * per_tap;", "n_chunks = 0;"),  # no weight loads either: the producer waits on none
    "no_epilogue_io": ("for (int idx = threadIdx.x; idx < C * kQuads; idx += kThreads) {",
                       "for (int idx = threadIdx.x; idx < 0; idx += kThreads) {"),
    "no_split": (_WG_SPLIT, "          hi[kk][i] = lo[kk][i] = r[i];"),
    "cvt_split": (_WG_SPLIT, """          asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi[kk][i]) : "f"(__uint_as_float(r[i])));
          const float rest = __fsub_rn(__uint_as_float(r[i]), __uint_as_float(hi[kk][i]));
          asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo[kk][i]) : "f"(rest));"""),
}


def variant_sources(dtype: str) -> dict[str, tuple[str, Path]]:
    """The kernels and each of the dtype's cut copies: name -> (source text, include directory), the
    wgmma kernel's under ``<name>.wgmma`` in fp32."""
    src = (build.CSRC / f"{LIB}.cu").read_text()
    wg_src = (build.CSRC / f"{WGMMA_LIB}.cu").read_text()
    jobs = {"full": (src, build.CSRC)}
    if dtype == "fp32":
        jobs["full.wgmma"] = (wg_src, build.CSRC)
    for cut, (old, new, dtypes) in CUTS.items():
        if dtype in dtypes:
            jobs[cut] = (edit(src, cut, [(old, new)]), build.CSRC)
            if dtype == "fp32":
                jobs[f"{cut}.wgmma"] = (edit(wg_src, cut, [WGMMA_CUTS[cut]]), build.CSRC)
    return jobs


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="K2's time by phase, on the card")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16", help="model dtype: the K2 route")
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if not torch.cuda.is_available():
        print("k2_phases: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    libs = build_variants("phases", variant_sources(args.dtype))
    cfg = build_task_config("bigvgan", "44100_512_2048").generator
    model = BigVGAN(cfg)
    model.load_state_dict(random_state_dict(cfg, 0))
    model = fold_weight_norm(model).cuda().eval().to(dtype)
    n_k = len(cfg.resblock_kernel_sizes)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes, t = [], 256
    for i, u in enumerate(cfg.upsample_rates):
        t *= u
        shapes.append((cfg.upsample_initial_channel // 2 ** (i + 1), t))
    with torch.inference_mode():
        for variant, path in libs.items():
            if variant.endswith(".wgmma"):
                continue
            build._libs[LIB] = ctypes.CDLL(path)  # amp_stage_kernel launches through these libraries from now on
            if f"{variant}.wgmma" in libs:
                wg = amp_block.bind_wgmma(ctypes.CDLL(libs[f"{variant}.wgmma"]))
                amp_block._wgmma_lib = lambda wg=wg: wg
            row = {"variant": variant, "dtype": args.dtype, "card": card}
            for b in (1, 16):
                for i, (c, t) in enumerate(shapes):
                    blocks = list(model.resblocks[i * n_k : (i + 1) * n_k])
                    x = torch.randn(b, c, t, device="cuda", generator=gen).to(dtype)
                    row[f"b{b}_stage{i}_ms"] = cuda_ms(lambda: amp_stage_kernel(blocks, x, cfg.snake_logscale), 3, warmup=1)
                row[f"b{b}_ms"] = sum(row[f"b{b}_stage{i}_ms"] for i in range(len(shapes)))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
