"""Counts of ``configs/hifigan-44k.json``: HiFiGAN's convs and transposed convs, and the gan task's training
step (``portbench/counts.py`` has the rules).  It has no AMP stage, so no K2 bound."""

from portbench import counts


def forward_flops(cfg: dict, frames: int) -> float:
    return counts.upsampler_forward_flops(cfg["generator"], frames, aa=False)


def train_step_flops(cfg: dict, batch: int, frames: int) -> float:
    return counts.gan_step_flops(cfg, forward_flops, batch, frames)
