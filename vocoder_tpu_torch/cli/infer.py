"""Inference CLI: mel or audio -> waveform, on the card.

Counterpart of ``vocoder_tpu/cli/infer.py``: load a reference-layout torch
checkpoint (``generator.`` prefix; ``--trust-checkpoint`` for one that pickles
objects besides tensors) or the latest generator of a port training run
(``--ckpt <workdir>`` or ``<workdir>/checkpoints``, whose ``config.json``
then sets the task config, as the JAX package's CLI does), fold weight norm,
then for each ``.wav``
(log-mel computed here, after an optional ``--pitch-shift``) or ``.npy`` /
``.pt`` mel input synthesise under ``torch.inference_mode()`` and write a
16-bit WAV.  Library convs and matmuls run in full fp32 (no TF32), as the
JAX package runs them at ``Precision.HIGHEST``.

    python -m vocoder_tpu_torch.cli.infer --model hifigan|bigvgan|vocos|refinegan|firefly_gan_base \\
        --resolution 44100_512_2048 --ckpt G.ckpt|workdir --input in_dir --output out_dir \\
        [--device cuda|cpu] [--chunk-frames N] [--batch N] [--pitch-shift SEMITONES] [--trust-checkpoint]
        [--model-parallel N]

A generator that consumes an f0 template (refinegan always; hifigan or
bigvgan whose workdir's ``config.json`` records ``use_template``) gets one per
channel, ``data/f0.py::f0_template`` of the resampled, pitch-shifted and
padded audio, on the host; it runs per file and unchunked, as in the JAX
package's CLI, and a precomputed mel is refused.

``--batch N`` synthesises N items per forward (hifigan, vocos, bigvgan): the
items (one per channel of each file) are sorted by length, each group is
padded to its longest item and run with ``frame_lengths``, whose per-layer
masking makes every row equal to that item's own forward.  Files longer than
``--chunk-frames`` mel frames go through overlap-chunked synthesis, one file
at a time, as every file does at ``--batch 1``.

``--model-parallel N`` shards the generator over N processes started by
torchrun (``torchrun --standalone --nproc_per_node N -m
vocoder_tpu_torch.cli.infer ... --model-parallel N``; one model group, no
data parallelism, as the JAX package's CLI): hifigan, bigvgan and vocos by
their ``param_specs`` after weight norm is folded (``parallel/tp.py``), the
other generators (refinegan, firefly_gan_base) storage-sharded: each rank
stores a slice of every folded weight of at least 65,536 elements and each
forward gathers them (``tp.storage_shard``, the JAX package's
``train_state_specs(params, mesh, None)``).  Each rank runs on its card
(NCCL; ``--device cpu``: gloo), every rank reads the same inputs and runs the
same forwards, and rank 0 writes the WAVs and prints.  N must be the number
of processes.

Runs on ``cuda`` unless ``--device cpu`` is given; it never falls back to the
CPU by itself.  It reads WAV, FLAC, Ogg/Vorbis and (where libmpg123 loads)
MP3 (``data/audio_io.py``).  Orbax checkpoints (the JAX package's) are not
ported.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from vocoder_tpu_torch.config import build_task_config, overlay_task_config
from vocoder_tpu_torch.convert import load_reference_state_dict
from vocoder_tpu_torch.data.audio_io import AUDIO_EXTENSIONS, read_audio, write_wav
from vocoder_tpu_torch.data.f0 import f0_template
from vocoder_tpu_torch.data.resample import resample
from vocoder_tpu_torch.models.registry import get_generator
from vocoder_tpu_torch.nn import fold_weight_norm, set_full_precision
from vocoder_tpu_torch.ops.spectral import log_mel_spectrogram
from vocoder_tpu_torch.parallel import dist, tp
from vocoder_tpu_torch.parallel.streaming import chunked_synthesis
from vocoder_tpu_torch.train.gan import GANTaskConfig, needs_template
from vocoder_tpu_torch.utils.checkpoint import CheckpointManager

MEL_SUFFIXES = {".npy", ".pt", ".pth"}
# Families whose forward takes frame_lengths (vocoder_tpu/cli/infer.py's batchable rule).
BATCHABLE = ("hifigan", "vocos", "bigvgan")


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    return device


def load_generator(ckpt: str | Path, task: GANTaskConfig, device: torch.device, trust: bool = False,
                   model_group: tp.ModelGroup | None = None) -> torch.nn.Module:
    """The generator with the checkpoint's weights, weight norm folded, in eval mode on device.

    ``ckpt``: a reference-layout file (``trust``: see ``load_reference_state_dict``), or a port
    training run's workdir or its ``checkpoints`` directory, whose latest checkpoint is read.
    ``model_group``: this rank's shard of the folded weights (the model's ``param_specs``, else its storage
    shards)."""
    gen = get_generator(task.generator_name)
    model = gen.module_cls(task.generator)
    path = Path(ckpt)
    if path.is_dir():
        run = path / "checkpoints" if (path / "checkpoints").is_dir() else path
        model.load_state_dict(CheckpointManager(run).load()["generator"])
    else:
        model.load_state_dict(load_reference_state_dict(path, keys=model.state_dict().keys(), trust=trust))
    fold_weight_norm(model)
    if gen.param_specs is not None:
        tp.shard_module(model, gen.param_specs(task.generator), model_group)
    else:
        tp.storage_shard(model, model_group)
    return model.to(device).eval()


def restore_task_config(task: GANTaskConfig, ckpt: str | Path) -> GANTaskConfig:
    """For a training run's directory: the task config its ``config.json`` records, over the preset
    (so overridden widths load), refusing another generator than ``--model`` names."""
    path = Path(ckpt)
    if not path.is_dir():
        return task
    for cand in (path / "config.json", path.parent / "config.json"):
        if cand.is_file():
            saved = json.loads(cand.read_text()).get("task", {})
            if saved.get("generator_name", task.generator_name) != task.generator_name:
                raise SystemExit(f"{cand} records generator {saved['generator_name']!r}; pass --model "
                                 f"accordingly (got {task.generator_name!r})")
            print(f"task config restored from {cand}", flush=True)
            return overlay_task_config(task, saved)
    return task


def load_mel_item(f: Path, task: GANTaskConfig, device: torch.device,
                  pitch_shift: float = 0.0) -> tuple[torch.Tensor, np.ndarray | None]:
    """One input file -> (mel (channels, num_mels, F) float32 on device, the audio it was computed from
    (channels, F * hop) float32 on the host, or None for a mel file).

    The per-file and the batched paths share it, so their preprocessing (mel
    auto-transpose, pitch shift, hop padding, log-mel) cannot drift apart."""
    suffix = f.suffix.lower()
    if suffix in MEL_SUFFIXES:
        if suffix == ".npy":
            mel = np.load(f)
        else:
            mel = torch.load(f, map_location="cpu", weights_only=True).float().numpy()
        if mel.ndim == 2:
            mel = mel[None]
        if mel.shape[-1] == task.num_mels:  # (C, F, num_mels) -> (C, num_mels, F)
            mel = mel.transpose(0, 2, 1)
        return torch.as_tensor(np.asarray(mel, np.float32), device=device), None
    audio, sr = read_audio(f)
    audio = resample(audio, sr, task.sampling_rate)
    if pitch_shift:  # a resample from a shifted rate, rounded down to a multiple of 100 Hz
        step = round(task.sampling_rate * 2 ** (pitch_shift / 12))
        audio = resample(audio, step - step % 100, task.sampling_rate)
    audio = np.pad(audio, ((0, 0), (0, (-audio.shape[-1]) % task.hop_length)))
    mel = log_mel_spectrogram(
        torch.as_tensor(audio, device=device),
        sample_rate=task.sampling_rate,
        n_fft=task.n_fft,
        hop_length=task.hop_length,
        win_length=task.win_length,
        n_mels=task.num_mels,
        f_max=task.sampling_rate // 2,
    )
    return mel, audio


def templates(audio: np.ndarray | None, task: GANTaskConfig) -> np.ndarray:
    """audio (C, F * hop) -> the f0 template of each channel (C, 1, F * hop), float32, on the host."""
    if audio is None:
        raise SystemExit(f"{task.generator_name} needs an f0 template derived from source audio; "
                         "precomputed-mel input has none. Pass audio files instead.")
    return np.stack([f0_template(ch, task.sampling_rate, task.hop_length) for ch in audio])[:, None, :]


def synthesize(model: torch.nn.Module, mel: torch.Tensor, task: GANTaskConfig, chunk_frames: int,
               template: torch.Tensor | None = None) -> torch.Tensor:
    """mel (C, num_mels, F) [+ template (C, 1, F * hop)] -> audio (C, 1, F * hop), chunked per
    channel past chunk_frames when there is no template."""
    if template is not None:
        return model(mel, template=template)
    if chunk_frames and mel.shape[2] > chunk_frames:
        return torch.cat(
            [
                chunked_synthesis(model, mel[i : i + 1], hop_length=task.hop_length, chunk_frames=chunk_frames)
                for i in range(mel.shape[0])
            ]
        )
    return model(mel)


def batchable(task: GANTaskConfig, batch: int) -> bool:
    """Whether ``--batch`` can run masked batches for this generator: a family with
    ``frame_lengths``, no f0 template, and an even (kernel - rate) at every upsample
    stage (an odd one would shift each item's output length by a sample a stage)."""
    gen = task.generator
    if batch <= 1 or task.generator_name not in BATCHABLE or needs_template(task):
        return False
    ups = zip(getattr(gen, "upsample_rates", ()), getattr(gen, "upsample_kernel_sizes", ()))
    return not any((k - u) % 2 for u, k in ups)


def min_batch_frames(task: GANTaskConfig) -> int:
    """The shortest file the batched path takes; shorter ones go per file.  BigVGAN's is
    ceil(32 / rates[0]) frames, as in the JAX package's CLI, so both CLIs batch the same files."""
    if task.generator_name == "bigvgan":
        return -(-32 // max(task.generator.upsample_rates[0], 1))
    return 1


def _write(out_root: Path, in_root: Path, f: Path, audio: np.ndarray, task: GANTaskConfig) -> Path:
    """Write the WAV (rank 0 alone under tensor parallelism); its path."""
    out_path = out_root / f.relative_to(in_root).with_suffix(".wav")
    if dist.is_main():
        out_path.parent.mkdir(parents=True, exist_ok=True)
        write_wav(out_path, audio, task.sampling_rate)
    return out_path


def say(msg: str) -> None:
    """Print on rank 0 (every process under tensor parallelism runs the same files)."""
    if dist.is_main():
        print(msg, flush=True)


def batched_synthesis(model, files: list[Path], task: GANTaskConfig, device: torch.device, args,
                      in_root: Path, out_root: Path) -> list[Path]:
    """Length-sorted exact batched synthesis of ``files``; returns the files deferred to
    the per-file path (longer than ``--chunk-frames``, or shorter than ``min_batch_frames``).

    Each channel of each file is one item.  Items are sorted by frame count and
    taken ``args.batch`` at a time; each group is padded to its longest item and
    runs in one forward with ``frame_lengths``, and row j, cut to its item's
    frames, is that item's audio."""
    min_frames = min_batch_frames(task)
    items, outs, deferred = [], {}, []  # items: (file, channel, mel (num_mels, F))
    for f in files:
        mel, _ = load_mel_item(f, task, device, args.pitch_shift)
        frames = mel.shape[2]
        if (args.chunk_frames and frames > args.chunk_frames) or frames < min_frames:
            deferred.append(f)
            continue
        outs[f] = [None] * mel.shape[0]
        items += [(f, c, mel[c]) for c in range(mel.shape[0])]
    items.sort(key=lambda it: it[2].shape[1])

    start, total_s = time.perf_counter(), 0.0
    for g0 in range(0, len(items), args.batch):
        group = items[g0 : g0 + args.batch]
        frames = [m.shape[1] for _, _, m in group]
        mel_b = torch.zeros(len(group), task.num_mels, max(frames), device=device)
        for j, (_, _, m) in enumerate(group):
            mel_b[j, :, : frames[j]] = m
        lens = torch.tensor(frames, dtype=torch.int32, device=device)
        audio = model(mel_b, frame_lengths=lens)[:, 0].float().cpu().numpy()
        for j, (f, c, _) in enumerate(group):
            outs[f][c] = audio[j, : frames[j] * task.hop_length]
            total_s += frames[j] * task.hop_length / task.sampling_rate
    if items:
        say(f"batched synthesis: {len(items)} items, {total_s:.2f}s audio in {time.perf_counter() - start:.2f}s")
    for f, chans in outs.items():
        say(f"{f.name}: -> {_write(out_root, in_root, f, np.stack(chans), task)}")
    return deferred


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Vocoder inference (PyTorch + CUDA)")
    ap.add_argument("--model", default="hifigan", help="hifigan, bigvgan, vocos, vocos_small, vocos_huge, refinegan "
                    "or firefly_gan_base")
    ap.add_argument("--resolution", default="44100_512_2048")
    ap.add_argument("--ckpt", required=True, help="reference-layout .ckpt/.pt with a generator. state_dict, "
                    "or a training run's workdir (or its checkpoints directory)")
    ap.add_argument("--trust-checkpoint", action="store_true",
                    help="load a reference checkpoint that pickles objects besides tensors (runs its code)")
    ap.add_argument("--input", required=True, help="audio/mel file or directory")
    ap.add_argument("--output", required=True, help="output directory")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--pitch-shift", type=float, default=0.0, help="semitones, applied to audio inputs")
    ap.add_argument(
        "--chunk-frames", type=int, default=2048,
        help="mel frames per synthesis chunk for long files (0 = single pass); bounds device memory",
    )
    ap.add_argument(
        "--batch", type=int, default=1,
        help="synthesise N items per forward (length-sorted, padded, exact by per-layer length masking; "
        "hifigan/vocos/bigvgan)",
    )
    ap.add_argument(
        "--model-parallel", type=int, default=1,
        help="shard the generator over N processes started by torchrun --nproc_per_node N (tensor "
        "parallelism by the model's param_specs: hifigan, bigvgan, vocos; the others' weights stored in "
        "shards and gathered for each forward)",
    )
    args = ap.parse_args(argv)

    task = restore_task_config(build_task_config(args.model, args.resolution), args.ckpt)
    joined = not torch.distributed.is_initialized()
    device = dist.init_from_env(args.device)  # under torchrun: this rank's card, or gloo on the CPU
    try:
        _run(args, task, resolve_device(str(device)))
    finally:
        if joined:
            dist.close()


def _run(args, task: GANTaskConfig, device: torch.device) -> None:
    world = dist.world_size()
    if args.model_parallel != world:
        raise SystemExit(f"--model-parallel {args.model_parallel} needs that many processes "
                         f"(torchrun --nproc_per_node {args.model_parallel}); there are {world}")
    set_full_precision()
    grid = tp.make_grid(args.model_parallel)
    model = load_generator(args.ckpt, task, device, args.trust_checkpoint, grid.model)
    if grid.model is not None:
        say(f"model-parallel inference: {args.model_parallel}-way tensor sharding "
            f"({torch.distributed.get_backend()}), {len(getattr(model, 'tp_params', {}))} tensors sharded")

    input_path = Path(args.input)
    files = [input_path] if input_path.is_file() else sorted(input_path.rglob("*"))
    files = [f for f in files if f.suffix.lower() in MEL_SUFFIXES | AUDIO_EXTENSIONS]
    in_root = input_path.parent if input_path.is_file() else input_path
    out_root = Path(args.output)
    with torch.inference_mode():
        if batchable(task, args.batch):
            files = batched_synthesis(model, files, task, device, args, in_root, out_root)
        elif args.batch > 1:
            say(f"--batch: falling back to per-file synthesis for {task.generator_name}")
        for f in files:
            start = time.perf_counter()
            mel, audio = load_mel_item(f, task, device, args.pitch_shift)
            template = None
            if needs_template(task):
                template = torch.as_tensor(templates(audio, task), device=device)
            fake = synthesize(model, mel, task, args.chunk_frames, template)[:, 0, :].float().cpu().numpy()
            out_path = _write(out_root, in_root, f, fake, task)
            dur = fake.shape[-1] / task.sampling_rate
            say(f"{f.name}: {dur:.2f}s audio in {time.perf_counter() - start:.2f}s -> {out_path}")


if __name__ == "__main__":
    main()
