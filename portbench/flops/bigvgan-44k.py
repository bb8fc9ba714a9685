"""Counts of ``configs/bigvgan-44k.json``: BigVGAN (convs, transposed convs and the anti-aliased activations'
FIRs), its AMP stages' bound, and the gan task's training step (``portbench/counts.py`` has the rules)."""

from portbench import counts


def forward_flops(cfg: dict, frames: int) -> float:
    return counts.upsampler_forward_flops(cfg["generator"], frames, aa=True)


def k2_bound_s(cfg: dict, frames: int, peak_flops: float, bytes_per_s: float) -> float:
    return counts.amp_stage_bound_s(cfg["generator"], frames, peak_flops, bytes_per_s)


def train_step_flops(cfg: dict, batch: int, frames: int) -> float:
    return counts.gan_step_flops(cfg, forward_flops, batch, frames)
