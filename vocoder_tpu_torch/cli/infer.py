"""Inference CLI: mel or audio -> waveform, on the card.

Counterpart of ``vocoder_tpu/cli/infer.py`` for per-file synthesis: load a
reference-layout torch checkpoint (``generator.`` prefix), fold weight norm,
then for each ``.wav`` (log-mel computed here) or ``.npy`` mel input
synthesise under ``torch.inference_mode()`` and write a 16-bit WAV.  Files
longer than ``--chunk-frames`` mel frames go through overlap-chunked
synthesis.

    python -m vocoder_tpu_torch.cli.infer --model bigvgan --resolution 44100_512_2048 \\
        --ckpt G.ckpt --input in_dir --output out_dir [--device cuda|cpu] [--chunk-frames N]

Runs on ``cuda`` unless ``--device cpu`` is given; it never falls back to the
CPU by itself.  ``--batch``, f0 templates, pitch shift, Orbax checkpoints and
FLAC/Ogg/MP3 input are not yet ported.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from vocoder_tpu_torch.config import TaskConfig, build_task_config
from vocoder_tpu_torch.convert import load_reference_state_dict
from vocoder_tpu_torch.data.audio_io import AUDIO_EXTENSIONS, read_audio, write_wav
from vocoder_tpu_torch.data.resample import resample
from vocoder_tpu_torch.models.registry import get_generator
from vocoder_tpu_torch.nn import fold_weight_norm
from vocoder_tpu_torch.ops.spectral import log_mel_spectrogram
from vocoder_tpu_torch.parallel.streaming import chunked_synthesis


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    return device


def load_generator(ckpt: str | Path, task: TaskConfig, device: torch.device) -> torch.nn.Module:
    """The generator with the checkpoint's weights, weight norm folded, in eval mode on device."""
    model = get_generator(task.generator_name).module_cls(task.generator)
    model.load_state_dict(load_reference_state_dict(ckpt))
    return fold_weight_norm(model).to(device).eval()


def load_mel(f: Path, task: TaskConfig, device: torch.device) -> torch.Tensor:
    """One input file -> mel (channels, num_mels, F) float32 on device."""
    if f.suffix.lower() == ".npy":
        mel = np.load(f)
        if mel.ndim == 2:
            mel = mel[None]
        if mel.shape[-1] == task.num_mels:  # (C, F, num_mels) -> (C, num_mels, F)
            mel = mel.transpose(0, 2, 1)
        return torch.as_tensor(np.asarray(mel, np.float32), device=device)
    audio, sr = read_audio(f)
    audio = resample(audio, sr, task.sampling_rate)
    audio = np.pad(audio, ((0, 0), (0, (-audio.shape[-1]) % task.hop_length)))
    return log_mel_spectrogram(
        torch.as_tensor(audio, device=device),
        sample_rate=task.sampling_rate,
        n_fft=task.n_fft,
        hop_length=task.hop_length,
        win_length=task.win_length,
        n_mels=task.num_mels,
        f_max=task.sampling_rate // 2,
    )


def synthesize(model: torch.nn.Module, mel: torch.Tensor, task: TaskConfig, chunk_frames: int) -> torch.Tensor:
    """mel (C, num_mels, F) -> audio (C, 1, F * hop), chunked per channel past chunk_frames."""
    if chunk_frames and mel.shape[2] > chunk_frames:
        return torch.cat(
            [
                chunked_synthesis(model, mel[i : i + 1], hop_length=task.hop_length, chunk_frames=chunk_frames)
                for i in range(mel.shape[0])
            ]
        )
    return model(mel)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Vocoder inference (PyTorch + CUDA)")
    ap.add_argument("--model", default="bigvgan")
    ap.add_argument("--resolution", default="44100_512_2048")
    ap.add_argument("--ckpt", required=True, help="reference-layout .ckpt/.pt with a generator. state_dict")
    ap.add_argument("--input", required=True, help="audio/mel file or directory")
    ap.add_argument("--output", required=True, help="output directory")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument(
        "--chunk-frames", type=int, default=2048,
        help="mel frames per synthesis chunk for long files (0 = single pass); bounds device memory",
    )
    args = ap.parse_args(argv)

    task = build_task_config(args.model, args.resolution)
    device = resolve_device(args.device)
    model = load_generator(args.ckpt, task, device)

    input_path = Path(args.input)
    files = [input_path] if input_path.is_file() else sorted(input_path.rglob("*"))
    in_root = input_path.parent if input_path.is_file() else input_path
    out_root = Path(args.output)
    with torch.inference_mode():
        for f in files:
            suffix = f.suffix.lower()
            if suffix != ".npy" and suffix not in AUDIO_EXTENSIONS:
                continue
            start = time.perf_counter()
            mel = load_mel(f, task, device)
            fake = synthesize(model, mel, task, args.chunk_frames)[:, 0, :].float().cpu().numpy()
            out_path = out_root / f.relative_to(in_root).with_suffix(".wav")
            out_path.parent.mkdir(parents=True, exist_ok=True)
            write_wav(out_path, fake, task.sampling_rate)
            dur = fake.shape[-1] / task.sampling_rate
            print(f"{f.name}: {dur:.2f}s audio in {time.perf_counter() - start:.2f}s -> {out_path}", flush=True)


if __name__ == "__main__":
    main()
