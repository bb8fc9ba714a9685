"""Log-mel front end on ``torch.stft``.

Counterpart of ``mel_filterbank`` and ``log_mel_spectrogram`` in
``vocoder_tpu/ops/spectral.py`` (the reference's LinearSpectrogram ->
slaney MelScale -> log): reflect padding of (win - hop) / 2 per side
("same_win"), a periodic Hann window of ``win_length`` centred in
``n_fft``, ``sqrt(power + 1e-6)``, the slaney filterbank and
``log(clamp(mel, 1e-5))``.  The JAX package computes this outside any Pallas
kernel, so the FFT here is the library's.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz * 3.0 / 200.0
    logstep = math.log(6.4) / 27.0
    mel = f * 3.0 / 200.0
    with np.errstate(divide="ignore"):
        log_mel = min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_mel, mel)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz * 3.0 / 200.0
    logstep = math.log(6.4) / 27.0
    f = m * 200.0 / 3.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0, f_max: float | None = None
) -> np.ndarray:
    """Slaney-scale, slaney-normalised mel filterbank, shape (n_freqs, n_mels)."""
    if f_max is None:
        f_max = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)

    m_min = _hz_to_mel_slaney(np.array(f_min))
    m_max = _hz_to_mel_slaney(np.array(f_max))
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz_slaney(m_pts)

    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
    fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def log_mel_spectrogram(
    x: torch.Tensor,
    *,
    sample_rate: int,
    n_fft: int,
    hop_length: int,
    win_length: int,
    n_mels: int,
    f_min: float = 0.0,
    f_max: float | None = None,
) -> torch.Tensor:
    """Log-mel features of (B, T) audio -> (B, n_mels, frames), fp32."""
    pads = ((win_length - hop_length) // 2, (win_length - hop_length + 1) // 2)
    x = F.pad(x.float()[:, None, :], pads, mode="reflect")[:, 0, :]
    window = torch.hann_window(win_length, periodic=True, device=x.device)
    spec = torch.stft(
        x, n_fft, hop_length=hop_length, win_length=win_length, window=window, center=False, return_complex=True
    )
    mag = torch.sqrt(spec.real.square() + spec.imag.square() + 1e-6)  # (B, bins, frames)
    fb = torch.as_tensor(mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max), device=x.device)
    mel = torch.einsum("bft,fm->bmt", mag, fb)
    return torch.log(torch.clamp(mel, min=1e-5))
