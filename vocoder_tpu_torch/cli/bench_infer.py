"""Inference throughput of any generator preset, timed on the card.

Counterpart of ``vocoder_tpu/cli/bench_infer.py``:

    python -m vocoder_tpu_torch.cli.bench_infer --model bigvgan --batch 16
    python -m vocoder_tpu_torch.cli.bench_infer --model vocos --batch 64 --frames 256 --dtype float32

Builds the preset of ``--model`` at ``--resolution`` with random weights from numpy seed 0
(``tools/profile_forward.py::build``: weight norm folded, the model cast to ``--dtype``, bf16 by default,
so that BigVGAN takes K2's bf16 route), and a log-mel-like batch of ``--batch`` x ``--frames`` (with an
f0 template where the generator consumes one).  fp32 convs and matmuls run in full fp32 (TF32 off), as
the inference CLI runs them.  Two warm-up calls, as ``profile_forward`` takes, then ``--iters`` calls
between two CUDA events (the host clock on the CPU).  Runs on ``--device cuda`` unless ``cpu`` is asked for.

Prints one JSON line with the JAX package's keys (``metric: generator_inference``, ``model``,
``backend`` "cuda" or "cpu", ``batch``, ``frames``, ``dtype``, ``ms_per_call``,
``audio_s_per_s_per_chip``) and the device's name.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from vocoder_tpu_torch.nn import set_full_precision
from vocoder_tpu_torch.tools.profile_forward import build, inputs
from vocoder_tpu_torch.tools.timing import cuda_ms


def main(argv=None):
    ap = argparse.ArgumentParser(description="Generator inference throughput (PyTorch + CUDA)")
    ap.add_argument("--model", default="hifigan")
    ap.add_argument("--resolution", default="44100_512_2048")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to time the generator on the CPU")
    set_full_precision()
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    task, _, model = build(args.model.replace("-", "_"), dtype, resolution=args.resolution, device=device)
    kw = inputs(task, args.batch, args.frames, dtype, device=device)
    with torch.inference_mode():
        if device.type == "cuda":
            ms = cuda_ms(lambda: model(**kw), args.iters, warmup=2)
        else:
            for _ in range(2):
                model(**kw)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                model(**kw)
            ms = (time.perf_counter() - t0) / args.iters * 1e3
    audio_s = args.batch * args.frames * task.hop_length / task.sampling_rate
    rec = {"metric": "generator_inference", "model": args.model, "backend": device.type,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "batch": args.batch, "frames": args.frames, "dtype": args.dtype, "ms_per_call": ms,
           "audio_s_per_s_per_chip": audio_s / (ms / 1e3)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
