"""Training CLI: the GAN trainer, on the card.

Counterpart of ``vocoder_tpu/cli/train.py``:

    python -m vocoder_tpu_torch.cli.train --model bigvgan --resolution 44100_512_2048 \\
        "data.train_roots=('/data/wavs',)" data.val_root=/data/val run.val_pesq=False \\
        run.workdir=logs/bigvgan [--device cuda|cpu]

Any dotted override of the ``TrainConfig`` tree (``vocoder_tpu_torch/config.py``)
follows the flags.  Runs on ``cuda`` unless ``--device cpu`` is given; it never
falls back to the CPU by itself.  Only the "gan" family of bigvgan and
hifigan trains so far (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import argparse

from vocoder_tpu_torch.config import build_train_config
from vocoder_tpu_torch.train.trainer import train


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a vocoder (PyTorch + CUDA)")
    ap.add_argument("--model", default="hifigan", help="generator preset: hifigan or bigvgan")
    ap.add_argument("--resolution", default="44100_512_2048")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="dotted config overrides key=value")
    args = ap.parse_args(argv)
    return train(build_train_config(args.model, args.resolution, args.overrides), args.device)


if __name__ == "__main__":
    main()
