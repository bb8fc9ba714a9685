"""Train-step throughput: the trainer's own generator and discriminator phases, timed on the card.

Counterpart of ``vocoder_tpu/cli/bench_train.py``:

    python -m vocoder_tpu_torch.cli.bench_train --model bigvgan --batch 16
    python -m vocoder_tpu_torch.cli.bench_train --model hifigan --compute-dtype float32 --memory-stats
    python -m vocoder_tpu_torch.cli.bench_train --model bigvgan --gen-checkpointing --g-only

Builds the preset's training state (``train/gan.py::create_train_state`` from seed 0) and a batch of
``--batch`` items of the task's ``num_frames`` of noise (numpy seed 0, amplitude 0.1, as the JAX
package's), then runs ``step.g_phase`` and ``step.d_phase`` of ``make_train_step``, the code the
trainer runs: one warm-up step, ``--iters`` whole steps between two CUDA events (the host clock on the
CPU), then ``--iters`` generator phases alone.  ``--g-only`` skips the discriminator phase;
``--gen-checkpointing`` sets the generator's ``checkpointing`` (BigVGAN and HiFiGAN recompute their
blocks in the backward).  ``--precision highest|default`` takes the place of the JAX package's
``--spectral-precision`` (an MXU pass count): it is the trainer's ``run.precision`` ("highest": fp32
convs and matmuls with TF32 off; "default": TF32 on).  Dotted overrides of the training config
(``task.num_frames=32`` ...) follow the flags.  Runs on ``--device cuda`` unless ``cpu`` is asked for.

Prints one JSON line with the JAX package's keys (``metric: gan_train_step``, ``model``, ``backend``
"cuda" or "cpu", ``batch``, ``compute_dtype``, ``total_ms``, ``g_ms``, ``audio_s_per_s``) and the port's
``precision``, ``loss_stft_dtype`` and ``gen_checkpointing``; with ``--memory-stats`` on the card a
second line (``metric: hbm_stats``): ``torch.cuda.max_memory_allocated`` over the timed steps and the
byte counters of ``torch.cuda.memory_stats()``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from vocoder_tpu_torch.config import build_train_config
from vocoder_tpu_torch.train import gan
from vocoder_tpu_torch.train.trainer import Timer, set_precision


def main(argv=None):
    ap = argparse.ArgumentParser(description="GAN train-step throughput (PyTorch + CUDA)")
    ap.add_argument("--model", default="hifigan")
    ap.add_argument("--resolution", default="44100_512_2048")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--compute-dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--loss-stft-dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--precision", default="highest", choices=("highest", "default"),
                    help="run.precision: highest = fp32 convs and matmuls (TF32 off), default = TF32")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--g-only", action="store_true", help="skip the discriminator phase")
    ap.add_argument("--gen-checkpointing", action="store_true",
                    help="recompute the generator's blocks in the backward (activation checkpointing)")
    ap.add_argument("--memory-stats", action="store_true", help="print the card's peak and byte counters")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="dotted training-config overrides key=value")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to time the step on the CPU")
    set_precision(args.precision)
    cfg = build_train_config(args.model, args.resolution, "gan", args.overrides).task.replace(
        compute_dtype=args.compute_dtype, loss_stft_dtype=args.loss_stft_dtype)
    if args.gen_checkpointing:
        if not any(f.name == "checkpointing" for f in dataclasses.fields(cfg.generator)):
            raise SystemExit(f"--gen-checkpointing: {type(cfg.generator).__name__} has no checkpointing flag")
        cfg = cfg.replace(generator=dataclasses.replace(cfg.generator, checkpointing=True))
    t_samples = cfg.num_frames * cfg.hop_length
    state = gan.create_train_state(cfg, 0, device)
    audio = np.random.default_rng(0).standard_normal((args.batch, 1, t_samples)).astype(np.float32) * 0.1
    batch = {"audio": torch.from_numpy(audio).to(device),
             "lengths": torch.full((args.batch,), t_samples, dtype=torch.int64, device=device)}
    step = gan.make_train_step(cfg)
    g_phase, d_phase = step.g_phase, step.d_phase

    def run(g_only: bool) -> None:
        _, audio_c, fake_c = g_phase(state, batch)
        if not g_only:
            d_phase(state, audio_c, fake_c)

    run(args.g_only)  # warm-up: the kernels' build, cuDNN's plans
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def ms_per_iter(g_only: bool) -> float:
        timer = Timer(device)
        timer.start()
        for _ in range(args.iters):
            run(g_only)
        timer.stop()
        return timer.seconds() * 1e3 / args.iters

    total_ms = ms_per_iter(args.g_only)
    g_ms = ms_per_iter(True)

    audio_s = args.batch * t_samples / cfg.sampling_rate
    rec = {"metric": "gan_train_step", "model": args.model, "backend": device.type, "batch": args.batch,
           "compute_dtype": args.compute_dtype, "loss_stft_dtype": args.loss_stft_dtype,
           "precision": args.precision, "gen_checkpointing": args.gen_checkpointing, "g_only": args.g_only,
           "iters": args.iters, "total_ms": total_ms, "g_ms": g_ms, "audio_s_per_s": audio_s / (total_ms / 1e3)}
    print(json.dumps(rec), flush=True)
    if args.memory_stats:
        if device.type != "cuda":
            print("bench_train: --memory-stats reads the card's allocator; none on the CPU", file=sys.stderr)
        else:
            stats = {k: v for k, v in torch.cuda.memory_stats(device).items() if "bytes" in k}
            print(json.dumps({"metric": "hbm_stats", "model": args.model, "compute_dtype": args.compute_dtype,
                              "gen_checkpointing": args.gen_checkpointing,
                              "max_memory_allocated": torch.cuda.max_memory_allocated(device), **stats}), flush=True)
    return rec


if __name__ == "__main__":
    main()
