"""Where a generator's forward spends the card's time, kernel by kernel, on one CUDA card.

    python -m vocoder_tpu_torch.tools.profile_forward --model vocos [--batch 1] [--dtype fp32] [--frames 256]

Builds the 44.1 kHz preset of ``--model`` (bigvgan, hifigan or vocos) with
random weights from numpy seed 0, warms the forward up twice, then times
``--iters`` forwards with CUDA events and traces the same number with
``torch.profiler``.  Prints one JSON line: the card's name and power limit,
the forward's ms (events), the card's busy ms per forward (the sum of the
traced kernels' durations) and its share of the forward, the kernel
launches per forward, and the kernels that take the most card time, grouped
by name.  The model runs with TF32 off, as the inference CLI runs it.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys

import numpy as np
import torch

from vocoder_tpu_torch.config import build_task_config
from vocoder_tpu_torch.models import bigvgan, hifigan, vocos
from vocoder_tpu_torch.models.registry import get_generator
from vocoder_tpu_torch.nn import fold_weight_norm, set_full_precision
from vocoder_tpu_torch.tools.timing import card_line, cuda_ms

RANDOM_WEIGHTS = {"bigvgan": bigvgan.random_state_dict, "hifigan": hifigan.random_state_dict,
                  "vocos": vocos.random_state_dict}


def kernel_times(prof) -> dict[str, list[float]]:
    """Kernel name -> the durations (µs) of its launches in the trace."""
    out = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name].append(e.time_range.elapsed_us())
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="A generator's forward, kernel by kernel, on the card")
    ap.add_argument("--model", choices=sorted(RANDOM_WEIGHTS), default="vocos")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="fp32")
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_forward: no CUDA device", file=sys.stderr)
        return 2
    set_full_precision()
    task = build_task_config(args.model, "44100_512_2048")
    model = get_generator(task.generator_name).module_cls(task.generator)
    model.load_state_dict(RANDOM_WEIGHTS[args.model](task.generator, 0))
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = fold_weight_norm(model).cuda().eval().to(dtype)
    rng = np.random.default_rng(0)
    mel = torch.from_numpy((rng.standard_normal((args.batch, task.num_mels, args.frames)) - 5.0).astype(np.float32))
    mel = mel.cuda().to(dtype)
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(mel), args.iters)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.iters):
                model(mel)
            torch.cuda.synchronize()
    kernels = kernel_times(prof)
    busy_ms = sum(sum(v) for v in kernels.values()) / 1e3 / args.iters
    top = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[: args.top]
    print(json.dumps({
        "card": card_line(), "model": args.model, "batch": args.batch, "dtype": args.dtype, "frames": args.frames,
        "ms": ms, "busy_ms": busy_ms if kernels else None, "busy_share": busy_ms / ms if kernels else None,
        "launches_per_forward": sum(len(v) for v in kernels.values()) / args.iters,
        "top": [{"kernel": name[:120], "ms_per_forward": sum(v) / 1e3 / args.iters,
                 "launches_per_forward": len(v) / args.iters} for name, v in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
