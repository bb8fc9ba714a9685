"""Where a GAN training step spends its time, by phase and by part, on one CUDA card.

    python -m vocoder_tpu_torch.tools.profile_train [--model bigvgan] [--batch 16] [--steps 8]

Builds the 44.1 kHz preset's training state (BigVGAN: random weights from
numpy seed 0; discriminators from the torch seed), a batch of ``--batch``
128-frame crops (65,536 samples) of sines and noise from a numpy seed, and
runs ``--steps`` steps of ``make_train_step`` in fp32 with TF32 off.  Each
step's generator phase and discriminator phase are timed with CUDA events;
the median over the steps from the third on is reported, with the training
rate in audio seconds a second and the peak device memory.  Then one more
step runs under ``torch.profiler``, and ``step_parts`` splits the card's
busy time: K1's forward (the ``aa_snake_kernel`` launches), the aa-snake
backward (``AASnakeFunction.backward``), cuDNN's convolutions (forward,
transposed and backward, generator and discriminators), the discriminators
(their forwards in both phases and the backward nodes those forwards
created) and the MR-STFT loss (its forward and its backward nodes).  The
parts overlap: the convs are counted in both the discriminators and the convs.
Prints one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

CONV_OPS = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose", "aten::convolution_backward")


def _ancestors(e):
    while e.cpu_parent is not None:
        e = e.cpu_parent
        yield e


def _descendants(e):
    for c in e.cpu_children:
        yield c
        yield from _descendants(c)


def _outermost(events, pred) -> list:
    return [e for e in events if pred(e) and not any(pred(a) for a in _ancestors(e))]


def step_parts(prof) -> dict[str, float]:
    """The traced step's card time by part, in µs: each host op's ``device_time_total`` (the card time
    of the kernels it launched, its children's included).  ``busy`` is every kernel's time."""
    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]

    def total(pred) -> float:
        return sum(e.device_time_total for e in _outermost(cpu, pred))

    def with_backward(label: str) -> float:
        """A range's forward, and the backward nodes of the autograd ops it recorded."""
        forward = _outermost(cpu, lambda e: e.name == label)
        seqs = {d.sequence_nr for e in forward for d in _descendants(e) if d.sequence_nr >= 0}
        return (sum(e.device_time_total for e in forward)
                + total(lambda e: "Backward" in e.name and e.sequence_nr in seqs and "::" not in e.name))

    kernels = [k for e in cpu for k in e.kernels]
    return {
        "busy": float(sum(k.duration for k in kernels)),
        "k1_forward": float(sum(k.duration for k in kernels if "aa_snake_kernel" in k.name)),
        "aa_snake_backward": total(lambda e: e.name == "aa_snake_backward"),
        "cudnn_convs": total(lambda e: e.name in CONV_OPS),
        "discriminators": with_backward("discriminators"),
        "mr_stft_loss": with_backward("mr_stft_loss"),
    }


def synthetic_batch(batch: int, samples: int, sampling_rate: int, seed: int, device) -> dict:
    """``batch`` items of sines plus noise, every item ``samples`` long."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / sampling_rate
    f0 = rng.uniform(100.0, 400.0, (batch, 1))
    audio = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.standard_normal((batch, samples))
    return {"audio": torch.from_numpy(audio[:, None].astype(np.float32)).to(device),
            "lengths": torch.full((batch,), samples, dtype=torch.int64, device=device)}


def measure_step(state, step_fn, batch: dict, task, steps: int) -> dict:
    """Per-phase CUDA-event ms of ``steps`` training steps (median over the third on), the rate, the
    peak memory over the timed steps, and one more step's parts under ``torch.profiler``."""
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        _, audio_c, fake_c = step_fn.g_phase(state, batch)
        ev[1].record()
        step_fn.d_phase(state, audio_c, fake_c)
        ev[2].record()
        times.append(ev)
    torch.cuda.synchronize()
    g = [a.elapsed_time(b) for a, b, _ in times][2:]
    d = [b.elapsed_time(c) for _, b, c in times][2:]
    total = [x + y for x, y in zip(g, d)]
    peak = torch.cuda.max_memory_allocated()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step_fn(state, batch)
        torch.cuda.synchronize()
    parts = step_parts(prof)
    busy = parts["busy"]
    audio_s = batch["audio"].shape[0] * batch["audio"].shape[2] / task.sampling_rate
    ms = statistics.median(total)
    return {
        "ms": ms, "g_phase_ms": statistics.median(g), "d_phase_ms": statistics.median(d),
        "steps_timed": len(total), "audio_s_per_step": audio_s, "audio_s_per_s": audio_s / (ms / 1e3),
        "peak_memory_bytes": peak, "profiled_busy_ms": busy / 1e3,
        "shares_of_busy": {k: v / busy for k, v in parts.items() if k != "busy"} if busy else None,
        "parts_ms": {k: v / 1e3 for k, v in parts.items()},
    }


def main(argv: list[str] | None = None) -> int:
    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models import bigvgan, hifigan
    from vocoder_tpu_torch.nn import set_full_precision
    from vocoder_tpu_torch.tools.timing import card_line
    from vocoder_tpu_torch.train import gan

    ap = argparse.ArgumentParser(description="A GAN training step, by phase and by part, on the card")
    ap.add_argument("--model", choices=("bigvgan", "hifigan"), default="bigvgan")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    set_full_precision()
    task = build_task_config(args.model, "44100_512_2048")
    state = gan.create_train_state(task, 0, "cuda")
    weights = {"bigvgan": bigvgan.random_state_dict, "hifigan": hifigan.random_state_dict}[args.model]
    state.generator.load_state_dict(weights(task.generator, 0))
    batch = synthetic_batch(args.batch, task.hop_length * task.num_frames, task.sampling_rate, 0, "cuda")
    rec = measure_step(state, gan.make_train_step(task), batch, task, args.steps)
    print(json.dumps({"card": card_line(), "model": args.model, "batch": args.batch, "dtype": "fp32", **rec}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
