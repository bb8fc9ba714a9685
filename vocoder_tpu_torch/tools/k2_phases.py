"""Where the bf16 K2 kernel's time goes: each phase cut out in turn, on the card.

    python -m vocoder_tpu_torch.tools.k2_phases        # from the repository root; one CUDA card

Builds copies of ``csrc/amp_conv_mma.cu`` in which one phase does nothing (the
aa-snake prologue, the tensor-core main loop, or the epilogue's reads and
writes of device memory), times the five AMP stages of the 44.1 kHz BigVGAN
(F = 256 frames, random weights from seed 0) through each at b1 and b16 with
CUDA events, and prints one JSON line per variant.  A phase's cost is the
full time minus the time without it; phases overlap across blocks, so the
costs need not add up to the full time.  The outputs of the cut variants are
wrong by design and are not checked.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from vocoder_tpu_torch.config import build_task_config
from vocoder_tpu_torch.models.bigvgan import BigVGAN, random_state_dict
from vocoder_tpu_torch.nn import fold_weight_norm
from vocoder_tpu_torch.ops import build
from vocoder_tpu_torch.ops.amp_block import ROUTES, amp_stage_kernel

# Each cut: (text in the source, what replaces it).
CUTS = {
    "no_prologue": ("  if (threadIdx.x < C * n_seg) {", "  if (false) {"),
    "no_mma": ("for (int q = 0; q < n_chunks; ++q) {", "for (int q = 0; q < 0; ++q) {"),
    "no_epilogue_io": ("for (int idx = threadIdx.x; idx < C * kQuads; idx += kThreads) {",
                       "for (int idx = threadIdx.x; idx < 0; idx += kThreads) {"),
}


def cuda_ms(fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_variants() -> dict[str, str]:
    """Compile the kernel and each cut copy in parallel; name -> shared library path."""
    name = ROUTES[torch.bfloat16]
    src = (build.CSRC / f"{name}.cu").read_text()
    out = build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    texts = {"full": src}
    for cut, (old, new) in CUTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"{cut}: the source no longer has exactly one {old!r}")
        texts[cut] = src.replace(old, new)
    procs = {}
    for variant, text in texts.items():
        cu, lib = out / f"{variant}.cu", out / f"{variant}.so"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(cu)]
        procs[variant] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{variant}: nvcc failed\n{log}")
        libs[variant] = str(lib)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_phases: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    libs = build_variants()
    cfg = build_task_config("bigvgan", "44100_512_2048").generator
    model = BigVGAN(cfg)
    model.load_state_dict(random_state_dict(cfg, 0))
    model = fold_weight_norm(model).cuda().eval().to(torch.bfloat16)
    n_k = len(cfg.resblock_kernel_sizes)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes, t = [], 256
    for i, u in enumerate(cfg.upsample_rates):
        t *= u
        shapes.append((cfg.upsample_initial_channel // 2 ** (i + 1), t))
    route = ROUTES[torch.bfloat16]
    with torch.inference_mode():
        for variant, path in libs.items():
            lib = ctypes.CDLL(path)
            build._libs[route] = lib  # amp_stage_kernel launches through this library from now on
            row = {"variant": variant, "card": card}
            for b in (1, 16):
                for i, (c, t) in enumerate(shapes):
                    blocks = list(model.resblocks[i * n_k : (i + 1) * n_k])
                    x = torch.randn(b, c, t, device="cuda", generator=gen).to(torch.bfloat16)
                    row[f"b{b}_stage{i}_ms"] = cuda_ms(lambda: amp_stage_kernel(blocks, x, cfg.snake_logscale))
                row[f"b{b}_ms"] = sum(row[f"b{b}_stage{i}_ms"] for i in range(len(shapes)))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
