"""PyTorch + CUDA port of the vocoder framework, for NVIDIA Hopper (H100).

This package stands beside the JAX package and imports nothing of it: the
host-side pieces it needs (presets, WAV I/O, the resampler, the f0
estimator) are its own copies.  It currently carries inference for BigVGAN,
HiFiGAN, Vocos, RefineGAN and Firefly-GAN end to end (BigVGAN and HiFiGAN
also with an f0 template), per file or, without a template, in exact padded
batches; GAN training of all five (BigVGAN and HiFiGAN with or without a
template) and of the vae and vqvae families; and the vqvae codec:

    python -m vocoder_tpu_torch.cli.infer --model bigvgan|hifigan|vocos|refinegan|firefly_gan_base \\
        --resolution 44100_512_2048 --ckpt G.ckpt --input in/ --output out/ [--batch 16]
    python -m vocoder_tpu_torch.cli.train [--model bigvgan|...|firefly_gan_base | --family vae|vqvae] \\
        "data.train_roots=('wavs/',)" run.workdir=logs/run
    python -m vocoder_tpu_torch.cli.codec encode|decode --ckpt logs/run --input in/ --output out/

Layout.  The generator keeps the JAX package's contract at its public
function: mel ``(B, num_mels, F)`` in, waveform ``(B, 1, F * hop)`` out.
Inside, every activation is channels-first ``(B, C, T)``, like the reference
and like ``torch.nn.Conv1d``; the JAX ops work channels-last ``(B, T, C)``,
so the parity tests transpose at that boundary.

Devices.  Entry points run on ``cuda`` unless the caller asks for ``cpu``.
Each hand-written kernel (``csrc/``) has its plain PyTorch version beside
its wrapper: a tensor on the CPU takes the plain version, a CUDA tensor
launches the kernel or raises.

Importing this package imports nothing heavy.
"""
