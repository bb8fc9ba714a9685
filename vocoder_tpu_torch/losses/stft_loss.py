"""Multi-resolution STFT loss.

Counterpart of ``vocoder_tpu/losses/stft_loss.py`` (the reference's
kan-bayashi formulation): per resolution, a center reflect-padded Hann
magnitude STFT with sqrt(max(power, 1e-6)); spectral convergence
||y - x||_F / ||y||_F and log-magnitude L1, each averaged over resolutions.
Magnitudes of bf16 waveforms (``task.loss_stft_dtype``) come back in bf16; the
norms and logs accumulate in fp32, as the JAX package's.

Inside ``parallel.dist.data_parallel`` both are this rank's share of the
global batch's loss: the log-magnitude term a mean share, and the spectral
convergence, a ratio of norms over the whole batch and no mean, the global
ratio of the all-reduced sums of squares, written so that its value is
1 / ranks of the global one and its gradient this rank's rows' part of the
global ratio's (the other ranks' sums enter detached).
"""

from __future__ import annotations

import torch

from vocoder_tpu_torch.ops.spectral import stft_magnitude
from vocoder_tpu_torch.parallel import dist


def stft_loss_single(x: torch.Tensor, y: torch.Tensor, res: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """x, y: (B, T) predicted and ground truth -> (spectral convergence, log-magnitude L1)."""
    n_fft, hop, win = res
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win, padding="center", mag_mode="clamp_inside")
    x_mag, y_mag = stft_magnitude(x, **kw).float(), stft_magnitude(y, **kw).float()
    mag = dist.mean_share(torch.abs(torch.log(y_mag) - torch.log(x_mag)))
    sums = torch.stack([torch.square(y_mag - x_mag).sum(), torch.square(y_mag).sum()])
    total = sums + (dist.all_reduce_sum(sums.detach().clone()) - sums.detach())  # this rank's rows differentiable
    sc = torch.sqrt(total[0]) / torch.sqrt(total[1])
    return sc + sc.detach() * (1.0 / dist.shard()[1] - 1.0), mag


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor, resolutions: tuple):
    """(spectral convergence, log-magnitude L1), each averaged over ``resolutions`` of (n_fft, hop, win)."""
    losses = [stft_loss_single(x, y, res) for res in resolutions]
    n = len(resolutions)
    return sum(sc for sc, _ in losses) / n, sum(mag for _, mag in losses) / n
