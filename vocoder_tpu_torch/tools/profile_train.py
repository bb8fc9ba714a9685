"""Where a GAN training step spends its time, by phase and by part, on one CUDA card.

    python -m vocoder_tpu_torch.tools.profile_train [--model bigvgan|hifigan|refinegan|vocos|firefly_gan_base]
        [--family gan|vae|vqvae] [--batch 16] [--steps 8] [--compute-dtype float32|bfloat16] [--checkpointing]

Builds the preset's training state (44.1 kHz; RefineGAN at 24 kHz, the only
resolution it builds at; ``--family vae|vqvae``: that family's generator,
``--model`` ignored; the generator's random weights from numpy seed 0, the
discriminators from the torch seed), a batch of ``--batch`` crops of the
task's ``num_frames`` (128 frames, 65,536 samples at 44.1 kHz and 32,768 at
24 kHz; the vqvae's 32 frames) of sines and noise from
a numpy seed, with each sine's f0 template where the generator consumes one,
and runs ``--steps`` steps of ``make_train_step`` with TF32 off, in fp32 or, with
``--compute-dtype bfloat16``, in the task's bf16 compute (``--checkpointing``: the
generator recomputes its blocks in the backward, BigVGAN and HiFiGAN).  Each
step's generator phase and discriminator phase are timed with CUDA events;
the median over the steps from the third on is reported, with the training
rate in audio seconds a second and the peak device memory.  Then one more
step runs under ``torch.profiler``: its top kernels by card time, and
``step_parts`` splits the card's busy time: K1's forward (the
``aa_snake_kernel`` launches), the aa-snake backward (the backward kernel's
``aa_snake_bwd`` launches), cuDNN's convolutions (forward,
transposed and backward, generator and discriminators), the discriminators
(their forwards in both phases and the backward nodes those forwards
created) and the MR-STFT loss (its forward and its backward nodes).  The
parts overlap: the convs are counted in both the discriminators and the convs.
For a generator that consumes a template it also times the host's f0
templates of the batch, one after another as ``batch_iterator`` makes them
and in a pool of the preset's ``data.num_workers`` threads, with
``OPENBLAS_NUM_THREADS`` beside them: run it with that variable at 1 to tell
the interpreter lock's hand-off from BLAS threads contending.  Prints one
JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from concurrent.futures import ThreadPoolExecutor
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


def launched_kernels(prof) -> list:
    """The kernels the traced host ops launched (not the ``record_function`` ranges the trace also shows
    on the card's timeline)."""
    return [k for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU for k in e.kernels]


def top_kernels(prof, top: int) -> list[dict]:
    """The ``top`` kernels by card time: name, ms and launches."""
    by_name: dict[str, list[float]] = {}
    for k in launched_kernels(prof):
        by_name.setdefault(k.name, []).append(k.duration)
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]
    return [{"kernel": name[:120], "ms": sum(v) / 1e3, "launches": len(v)} for name, v in ranked]


def step_parts(prof) -> dict[str, float]:
    """The traced step's card time by part, in µs: each host op's ``device_time_total`` (the card time
    of the kernels it launched, its children's included), and K1's kernels and its backward's by name (a
    launch through ctypes is no child of the range around it in the profiler's events).  ``busy`` is every
    kernel's time."""
    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]

    def total(pred) -> float:
        return sum(e.device_time_total for e in _outermost(cpu, pred))

    def with_backward(label: str) -> float:
        """A range's forward, and the backward nodes of the autograd ops it recorded."""
        forward = _outermost(cpu, lambda e: e.name == label)
        seqs = {d.sequence_nr for e in forward for d in _descendants(e) if d.sequence_nr >= 0}
        return (sum(e.device_time_total for e in forward)
                + total(lambda e: "Backward" in e.name and e.sequence_nr in seqs and "::" not in e.name))

    kernels = launched_kernels(prof)
    return {
        "busy": float(sum(k.duration for k in kernels)),
        "k1_forward": float(sum(k.duration for k in kernels if "aa_snake_kernel" in k.name)),
        "aa_snake_backward": float(sum(k.duration for k in kernels if "aa_snake_bwd" in k.name)),
        "cudnn_convs": total(lambda e: e.name in CONV_OPS),
        "discriminators": with_backward("discriminators"),
        "mr_stft_loss": with_backward("mr_stft_loss"),
    }


def synthetic_batch(batch: int, samples: int, sampling_rate: int, seed: int, device, hop: int | None = None) -> dict:
    """``batch`` items of sines plus noise, every item ``samples`` long; with ``hop``, also each sine's f0
    template (``template_from_f0`` of its constant f0)."""
    from vocoder_tpu_torch.data.f0 import template_from_f0

    rng = np.random.default_rng(seed)
    t = np.arange(samples) / sampling_rate
    f0 = rng.uniform(100.0, 400.0, (batch, 1))
    audio = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.standard_normal((batch, samples))
    out = {"audio": torch.from_numpy(audio[:, None].astype(np.float32)).to(device),
           "lengths": torch.full((batch,), samples, dtype=torch.int64, device=device)}
    if hop is not None:
        tpl = np.stack([template_from_f0(np.full(samples // hop, f[0]), sampling_rate, hop) for f in f0])
        out["template"] = torch.from_numpy(tpl[:, None]).to(device)
    return out


def measure_step(state, step_fn, batch: dict, task, steps: int, top: int = 6) -> dict:
    """Per-phase CUDA-event ms of ``steps`` training steps (median over the third on), the rate, the
    peak memory over the timed steps, and one more step's parts and ``top`` kernels by card time under
    ``torch.profiler``."""
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
        "top": top_kernels(prof, top),
    }


def f0_seconds(task, batch: dict, threads: int) -> dict:
    """The host's seconds for the f0 templates of the batch's audio, one after another and in a pool of
    ``threads`` threads; the two must give the same templates."""
    from vocoder_tpu_torch.data.f0 import f0_template

    audio = list(batch["audio"][:, 0].cpu().numpy())

    def template(a):
        return f0_template(a, task.sampling_rate, task.hop_length)

    t0 = time.perf_counter()
    one = [template(a) for a in audio]
    serial_s = time.perf_counter() - t0
    with ThreadPoolExecutor(max_workers=threads) as pool:
        t0 = time.perf_counter()
        pooled = list(pool.map(template, audio))
        pool_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(one, pooled)):
        raise SystemExit("f0 templates made in a thread pool differ from one thread's")
    return {"f0_seconds_per_batch": serial_s, "f0_seconds_per_batch_pool": pool_s, "f0_pool_threads": threads,
            "openblas_num_threads": os.environ.get("OPENBLAS_NUM_THREADS")}


def training_setup(model: str, batch: int, seed: int, device="cuda", family: str = "gan",
                   compute_dtype: str = "float32", checkpointing: bool = False):
    """(task, state, batch): the preset's (or the family's) training state with the generator's random
    weights from ``seed`` and a synthetic batch of the task's crops (with templates where the generator
    needs them); the task in ``compute_dtype``, the generator's ``checkpointing`` set where asked."""
    import dataclasses

    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models.vae import vae_random_state_dict, vqvae_random_state_dict
    from vocoder_tpu_torch.tools.profile_forward import RANDOM_WEIGHTS, RESOLUTION
    from vocoder_tpu_torch.train import gan

    task = build_task_config(model, RESOLUTION.get(model, "44100_512_2048"), family)
    task = task.replace(compute_dtype=compute_dtype)
    if checkpointing:
        task = task.replace(generator=dataclasses.replace(task.generator, checkpointing=True))
    state = gan.create_train_state(task, seed, device)
    weights = {**RANDOM_WEIGHTS, "vae": vae_random_state_dict, "vqvae": vqvae_random_state_dict}
    state.generator.load_state_dict(weights[task.generator_name](task.generator, seed))
    hop = task.hop_length if gan.needs_template(task) else None
    return task, state, synthetic_batch(batch, task.hop_length * task.num_frames, task.sampling_rate, seed, device,
                                        hop)


def main(argv: list[str] | None = None) -> int:
    from vocoder_tpu_torch.config import DataConfig
    from vocoder_tpu_torch.nn import set_full_precision
    from vocoder_tpu_torch.tools.profile_forward import RANDOM_WEIGHTS
    from vocoder_tpu_torch.tools.timing import card_line
    from vocoder_tpu_torch.train import gan

    ap = argparse.ArgumentParser(description="A GAN training step, by phase and by part, on the card")
    ap.add_argument("--model", choices=sorted(RANDOM_WEIGHTS), default="bigvgan", help="the gan family's preset")
    ap.add_argument("--family", choices=("gan", "vae", "vqvae"), default="gan")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--checkpointing", action="store_true", help="the generator recomputes its blocks in the backward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    set_full_precision()
    task, state, batch = training_setup(args.model, args.batch, 0, family=args.family,
                                        compute_dtype=args.compute_dtype, checkpointing=args.checkpointing)
    rec = measure_step(state, gan.make_train_step(task), batch, task, args.steps)
    if gan.needs_template(task):
        rec.update(f0_seconds(task, batch, DataConfig().num_workers))
    print(json.dumps({"card": card_line(), "model": task.generator_name, "batch": args.batch,
                      "dtype": {"float32": "fp32", "bfloat16": "bf16"}[args.compute_dtype],
                      "checkpointing": args.checkpointing, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
