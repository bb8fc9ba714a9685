"""Neural codec CLI: audio <-> discrete codes through a VQ-VAE or HuBERT-codec training run, on the card.

Counterpart of ``vocoder_tpu/cli/codec.py``:

    python -m vocoder_tpu_torch.cli.codec encode --ckpt <workdir> --input wavs/ --output codes/ \\
        [--family vqvae|ssl] [--resolution 44100_512_2048] [--device cuda|cpu]
    python -m vocoder_tpu_torch.cli.codec decode --ckpt <workdir> --input codes/ --output wavs_out/

``--ckpt`` is a port training run's workdir (``cli.train --family vqvae`` or
``--family ssl``) or its ``checkpoints`` directory: the latest checkpoint's
generator, the codebooks with it, and the task config its ``config.json``
records over the preset.  ``encode`` reads each audio file, averages its
channels, resamples to the task's rate, zero-pads to a whole hop, and takes
the linear spectrogram (vqvae) or the frozen HuBERT's features of that audio
(ssl, ``models/ssl_encoders.py``: the snapshot the run's config names, else
the random backbone of seed 0 that the run trained on), then writes the
codes (Q, 1, F) as int32 ``<name>.codes.npy`` (the input's path under
``--output``); ``decode`` turns each ``.codes.npy`` back into a 16-bit WAV,
all in ``--output`` itself, as the JAX package's CLI does.  Convs and
matmuls run in full fp32 (TF32 off); the VQ's distance product and the
backbone do in any case.  Runs on ``cuda`` unless ``--device cpu`` is given,
and never falls back to the CPU by itself.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from vocoder_tpu_torch.cli.infer import resolve_device, restore_task_config
from vocoder_tpu_torch.config import build_task_config
from vocoder_tpu_torch.data.audio_io import AUDIO_EXTENSIONS, read_audio, write_wav
from vocoder_tpu_torch.data.resample import resample
from vocoder_tpu_torch.models.registry import get_generator
from vocoder_tpu_torch.models.ssl_encoders import HubertFeatureExtractor
from vocoder_tpu_torch.nn import fold_weight_norm, set_full_precision
from vocoder_tpu_torch.ops.spectral import linear_spectrogram
from vocoder_tpu_torch.utils.checkpoint import CheckpointManager


def load_codec(ckpt: str | Path, task, device: torch.device) -> torch.nn.Module:
    """The latest generator of a vqvae or ssl training run (``VQVAEGenerator``, ``SSLCodecGenerator``),
    weight norm folded, in eval mode on device."""
    path = Path(ckpt)
    run = path / "checkpoints" if (path / "checkpoints").is_dir() else path
    model = get_generator(task.generator_name).module_cls(task.generator)
    model.load_state_dict(CheckpointManager(run).load()["generator"])
    return fold_weight_norm(model).to(device).eval()


def _files(in_root: Path) -> list[Path]:
    return [in_root] if in_root.is_file() else sorted(p for p in in_root.rglob("*") if p.is_file())


def main(argv=None):
    ap = argparse.ArgumentParser(description="VQ-VAE / SSL-semantic audio codec (PyTorch + CUDA)")
    ap.add_argument("mode", choices=["encode", "decode"])
    ap.add_argument("--ckpt", required=True,
                    help="a vqvae or ssl training run's workdir or its checkpoints directory")
    ap.add_argument("--resolution", default="44100_512_2048")
    ap.add_argument("--family", default="vqvae", choices=["vqvae", "ssl"],
                    help="vqvae = spectrogram codec; ssl = HuBERT semantic codec (hifigan-vae)")
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    task = build_task_config(family=args.family, resolution=args.resolution)
    device = resolve_device(args.device)
    set_full_precision()
    task = restore_task_config(task, args.ckpt)
    model = load_codec(args.ckpt, task, device)
    ssl_encode = args.family == "ssl" and args.mode == "encode"
    extractor = HubertFeatureExtractor(task.generator.hubert, device) if ssl_encode else None
    in_root, out_root = Path(args.input), Path(args.output)
    with torch.inference_mode():
        for f in _files(in_root):
            if args.mode == "encode":
                if f.suffix.lower() not in AUDIO_EXTENSIONS:
                    continue
                audio, sr = read_audio(f)
                audio = resample(audio.mean(0), sr, task.sampling_rate)
                audio = np.pad(audio, (0, (-len(audio)) % task.hop_length))
                x = torch.from_numpy(np.ascontiguousarray(audio, np.float32))[None].to(device)
                if extractor is not None:  # ssl: the frozen backbone's features, not a spectrogram
                    inputs = extractor(x)
                else:
                    inputs = linear_spectrogram(x, n_fft=task.n_fft, hop_length=task.hop_length,
                                                win_length=task.win_length)
                codes = model.encode_to_codes(inputs).cpu().numpy().astype(np.int32)
                rel = f.relative_to(in_root if in_root.is_dir() else in_root.parent)
                out = out_root / rel.with_suffix(".codes.npy")
                out.parent.mkdir(parents=True, exist_ok=True)
                np.save(out, codes)
                print(f"{f.name}: {codes.shape} codes -> {out}", flush=True)
            else:
                if not f.name.endswith(".codes.npy"):
                    continue
                codes = torch.from_numpy(np.load(f).astype(np.int64)).to(device)
                audio = model.decode_from_codes(codes).float().cpu().numpy()
                out = out_root / f.name.replace(".codes.npy", ".wav")
                out.parent.mkdir(parents=True, exist_ok=True)
                write_wav(out, audio[:, 0, :], task.sampling_rate)
                print(f"{f.name}: -> {out}", flush=True)


if __name__ == "__main__":
    main()
