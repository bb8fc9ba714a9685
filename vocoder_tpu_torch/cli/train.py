"""Training CLI: the GAN trainer, on the card.

Counterpart of ``vocoder_tpu/cli/train.py``:

    python -m vocoder_tpu_torch.cli.train --model bigvgan --resolution 44100_512_2048 \\
        "data.train_roots=('/data/wavs',)" data.val_root=/data/val \\
        run.workdir=logs/bigvgan [--family gan|vae|vqvae|ssl] [--device cuda|cpu]

Any dotted override of the ``TrainConfig`` tree (``vocoder_tpu_torch/config.py``)
follows the flags.  Runs on ``cuda`` unless ``--device cpu`` is given; it never
falls back to the CPU by itself.  The "gan" family trains every generator
preset (hifigan, bigvgan, refinegan, vocos, vocos_small, vocos_huge,
firefly_gan_base); ``--family vae``, ``--family vqvae`` and ``--family ssl``
(the HuBERT semantic codec, at ``--resolution 16000_640_2048`` for 16 kHz
audio; its frozen backbone is a local snapshot named by
``task.generator.hubert.model_name_or_path``, else random weights) train their
own generators (``--model`` is then ignored).  ``task.compute_dtype=bfloat16``
trains in mixed precision (bf16 forwards and backwards on fp32 master weights,
BigVGAN through K1's and, in validation, K2's bf16 routes),
``task.loss_stft_dtype=bfloat16`` takes the MR-STFT and mel losses of bf16
waveforms, ``task.generator.checkpointing=True`` recomputes BigVGAN's AMP
blocks (HiFiGAN's resblock groups) in the backward, and
``run.profile_steps=(3,5)`` writes a ``torch.profiler`` trace of steps 3 and 4
under ``<workdir>/profile/``.

Data-parallel training on N cards of one host, one process each (NCCL; each
rank trains on its card, ``cuda:LOCAL_RANK``, a share of ``data.batch_size``,
and the step is the global batch's):

    torchrun --standalone --nproc_per_node N -m vocoder_tpu_torch.cli.train --model bigvgan ...

and on the CPU over gloo with ``--device cpu``.  Rank 0 writes the workdir.
With ``run.model_parallel=M`` (M dividing N) each M consecutive ranks hold one
generator in shards (tensor parallelism, ``parallel/tp.py``: hifigan, bigvgan
and vocos by their ``param_specs``; the discriminators, the other generators and
the vq codebooks in storage shards, gathered where they are used) and data
parallelism runs over the N // M model groups (``run.data_parallel``, if given,
must be N // M).
"""

from __future__ import annotations

import argparse

from vocoder_tpu_torch.config import FAMILIES, build_train_config
from vocoder_tpu_torch.parallel import dist
from vocoder_tpu_torch.train.trainer import train


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a vocoder (PyTorch + CUDA)")
    ap.add_argument("--model", default="hifigan", help="generator preset of the gan family, e.g. hifigan or bigvgan")
    ap.add_argument("--resolution", default="44100_512_2048")
    ap.add_argument("--family", default="gan", choices=FAMILIES, help="model family")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="dotted config overrides key=value")
    args = ap.parse_args(argv)
    state = train(build_train_config(args.model, args.resolution, args.family, args.overrides), args.device)
    dist.close()
    return state


if __name__ == "__main__":
    main()
