"""Where a generator's forward spends the card's time, kernel by kernel, on one CUDA card.

    python -m vocoder_tpu_torch.tools.profile_forward --model vocos [--batch 1] [--dtype fp32] [--frames 256] \\
        [--template]

Builds the preset of ``--model`` (bigvgan, hifigan, vocos, refinegan or
firefly_gan_base) at 44.1 kHz (refinegan at 24 kHz, the only resolution it
builds at) with random weights from numpy seed 0 (``--template``: BigVGAN or
HiFiGAN with ``use_template``), and for a generator that consumes
one, an f0 template of a 220 Hz tone; warms the forward up twice, then times
``--iters`` forwards with CUDA events and traces the same number with
``torch.profiler``.  Prints one JSON line: the card's name and power limit,
the forward's ms (events), the card's busy ms per forward (the sum of the
traced kernels' durations) and its share of the forward, the kernel
launches per forward, K2's card ms per forward (``amp_conv_mma`` kernels)
and the kernels that take the most card time, grouped by name.  The model
runs with TF32 off, as the inference CLI runs it.  ``chip_smoke.py`` calls
``build`` and ``profile`` in its own process.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys

import numpy as np
import torch

from vocoder_tpu_torch.config import build_task_config
from vocoder_tpu_torch.data.f0 import template_from_f0
from vocoder_tpu_torch.models import bigvgan, firefly, hifigan, refinegan, vocos
from vocoder_tpu_torch.models.registry import get_generator
from vocoder_tpu_torch.nn import fold_weight_norm, set_full_precision
from vocoder_tpu_torch.tools.timing import card_line, cuda_ms
from vocoder_tpu_torch.train.gan import needs_template

RANDOM_WEIGHTS = {"bigvgan": bigvgan.random_state_dict, "hifigan": hifigan.random_state_dict,
                  "vocos": vocos.random_state_dict, "refinegan": refinegan.random_state_dict,
                  "firefly_gan_base": firefly.random_state_dict}
RESOLUTION = {"refinegan": "24000_256_1024"}  # the only one its rates build at


def kernel_times(prof) -> dict[str, list[float]]:
    """Kernel name -> the durations (µs) of its launches in the trace.  The device-side copies of the
    forward's spans (``record_function`` ranges, nested, each spanning the kernels inside it) are left out:
    counted as kernels, they read the card busy two to three times over."""
    out = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            out[e.name].append(e.time_range.elapsed_us())
    return out


def build(name: str, dtype: torch.dtype, template: bool = False, seed: int = 0, resolution: str | None = None,
          device: str | torch.device = "cuda"):
    """(task, the preset's random state dict from ``seed``, fp32 on the host, and the model holding it,
    folded, on ``device`` in ``dtype``), at ``resolution`` (default: 44.1 kHz, RefineGAN's 24 kHz)."""
    task = build_task_config(name, resolution or RESOLUTION.get(name, "44100_512_2048"))
    if template:
        task = task.replace(generator=dataclasses.replace(task.generator, use_template=True))
    sd = RANDOM_WEIGHTS[task.generator_name](task.generator, seed)
    model = get_generator(task.generator_name).module_cls(task.generator)
    model.load_state_dict(sd)
    return task, sd, fold_weight_norm(model).to(device).eval().to(dtype)


def inputs(task, batch: int, frames: int, dtype: torch.dtype, seed: int = 0,
           device: str | torch.device = "cuda") -> dict:
    """The forward's keyword inputs: a log-mel-like ``mel`` and, where the generator consumes one, the
    f0 ``template`` of a 220 Hz tone, on ``device`` in ``dtype``."""
    rng = np.random.default_rng(seed)
    mel = (rng.standard_normal((batch, task.num_mels, frames)) - 5.0).astype(np.float32)
    out = {"mel": torch.from_numpy(mel).to(device, dtype)}
    if needs_template(task):
        tpl = template_from_f0(np.full(frames, 220.0), task.sampling_rate, task.hop_length)
        out["template"] = torch.from_numpy(np.broadcast_to(tpl, (batch, 1, tpl.size)).copy()).to(device, dtype)
    return out


def forward_ms(model, kw: dict, iters: int = 3) -> float:
    """CUDA-event ms of ``model(**kw)`` under ``torch.inference_mode``, over ``iters`` calls after two warm-up
    calls: the forward's time as ``profile`` reports it."""
    with torch.inference_mode():
        return cuda_ms(lambda: model(**kw), iters)


def profile(model, kw: dict, iters: int = 3, top: int = 12) -> dict:
    """CUDA-event ms of ``model(**kw)`` (``forward_ms``), then the same forwards traced: busy ms and share,
    launches, K2's ms (``amp_conv_mma`` kernels) and the ``top`` kernels by card time, all per forward."""
    ms = forward_ms(model, kw, iters)
    with torch.inference_mode():
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                model(**kw)
            torch.cuda.synchronize()
    kernels = kernel_times(prof)
    busy_ms = sum(sum(v) for v in kernels.values()) / 1e3 / iters
    k2_ms = sum(sum(v) for name, v in kernels.items() if "amp_conv_mma" in name) / 1e3 / iters
    ranked = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:top]
    return {"ms": ms, "busy_ms": busy_ms if kernels else None, "busy_share": busy_ms / ms if kernels else None,
            "launches_per_forward": sum(len(v) for v in kernels.values()) / iters, "k2_ms": k2_ms,
            "top": [{"kernel": name[:120], "ms_per_forward": sum(v) / 1e3 / iters,
                     "launches_per_forward": len(v) / iters} for name, v in ranked]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="A generator's forward, kernel by kernel, on the card")
    ap.add_argument("--model", choices=sorted(RANDOM_WEIGHTS), default="vocos")
    ap.add_argument("--template", action="store_true", help="bigvgan or hifigan with use_template")
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
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    task, _, model = build(args.model, dtype, args.template)
    rec = profile(model, inputs(task, args.batch, args.frames, dtype), args.iters, args.top)
    print(json.dumps({"card": card_line(), "model": args.model, "template": needs_template(task),
                      "batch": args.batch, "dtype": args.dtype, "frames": args.frames, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
