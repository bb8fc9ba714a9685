"""Magnitude STFT and log-mel on ``torch.stft``, and the Vocos "same" iSTFT.

Counterpart of ``stft_magnitude``, ``mel_filterbank``, ``log_mel_spectrogram``,
``linear_spectrogram``, ``overlap_add`` and ``istft_same`` in
``vocoder_tpu/ops/spectral.py``.  ``stft_magnitude`` takes the JAX package's
padding modes, all reflect: "same_win" ((win - hop) / 2 per side, the
log-mel's), "same_nfft" ((n_fft - hop) / 2, the MRD's) and "center" (n_fft / 2,
the MR-STFT loss's); windows "hann" (periodic, ``win_length`` centred in
``n_fft``) and "boxcar" (the MRD's torch.stft without a window); magnitudes
"eps_inside" sqrt(power + 1e-6), "clamp_inside" sqrt(max(power, 1e-6)) and
"plain" sqrt(power), whose subgradient at zero power is 0 as torch.norm's is
(a plain sqrt would send inf, and NaN the generator's gradient).  The linear
spectrogram (the vae and vqvae families' input) is "same_win" and
"eps_inside", the log-mel's magnitude before the filterbank.  The log-mel
is the reference's LinearSpectrogram -> slaney MelScale -> log: "same_win",
"eps_inside", the slaney filterbank and ``log(clamp(mel, 1e-5))``.  The iSTFT is an inverse real FFT
per frame (``torch.fft.irfft``; not ``torch.istft``, which pads and
normalises otherwise), the Hann window, an explicit overlap-add and the
division by the window-square envelope.  The JAX package computes both
outside any Pallas kernel, so the FFTs here are the library's; cuFFT has no
bf16 transform, so both run in fp32.

A bf16 input (the MR-STFT and mel losses under ``task.loss_stft_dtype``, the
MRD under ``task.compute_dtype``) is framed and transformed in fp32 and its
magnitudes are rounded to bf16; the log-mel's filterbank product and log then
run in bf16.  The JAX package's bf16 magnitudes come out of a bf16 DFT
matmul (its basis cast to the input's dtype) instead, so the two differ by
the rounding inside that matmul: held to each other by
``tests/test_torch_bf16_train.py`` at the tolerance stated there.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window, fp32, computed in float64 as the JAX package computes it."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


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


_PADDING = {
    "same_win": lambda n_fft, hop, win: ((win - hop) // 2, (win - hop + 1) // 2),
    "same_nfft": lambda n_fft, hop, win: ((n_fft - hop) // 2, (n_fft - hop + 1) // 2),
    "center": lambda n_fft, hop, win: (n_fft // 2, n_fft // 2),
}


def stft_magnitude(x: torch.Tensor, *, n_fft: int, hop_length: int, win_length: int, padding: str = "same_win",
                   mag_mode: str = "eps_inside", window: str = "hann") -> torch.Tensor:
    """Magnitude STFT of (B, T) audio -> (B, n_fft // 2 + 1, frames), fp32; bf16 for a bf16 x (fp32 inside)."""
    if padding not in _PADDING:
        raise ValueError(f"unknown padding mode {padding!r}")
    rounded = x.dtype == torch.bfloat16
    if window == "hann":
        win = torch.as_tensor(hann_window(win_length), device=x.device)
    elif window == "boxcar":
        win = torch.ones(win_length, device=x.device)
    else:
        raise ValueError(f"unknown window {window!r}")
    x = F.pad(x.float()[:, None, :], _PADDING[padding](n_fft, hop_length, win_length), mode="reflect")[:, 0, :]
    spec = torch.stft(x, n_fft, hop_length=hop_length, win_length=win_length, window=win, center=False,
                      return_complex=True)
    power = spec.real.square() + spec.imag.square()
    if mag_mode == "eps_inside":
        mag = torch.sqrt(power + 1e-6)
    elif mag_mode == "clamp_inside":
        mag = torch.sqrt(torch.clamp(power, min=1e-6))
    elif mag_mode == "plain":
        nonzero = power > 0
        mag = torch.where(nonzero, torch.sqrt(torch.where(nonzero, power, 1.0)), 0.0)
    else:
        raise ValueError(f"unknown mag_mode {mag_mode!r}")
    return mag.to(torch.bfloat16) if rounded else mag


def linear_spectrogram(x: torch.Tensor, *, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """The reference's LinearSpectrogram of (B, T) audio -> (B, n_fft // 2 + 1, frames), fp32 (bf16 for a bf16 x)."""
    return stft_magnitude(x, n_fft=n_fft, hop_length=hop_length, win_length=win_length, padding="same_win",
                          mag_mode="eps_inside")


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
    """Log-mel features of (B, T) audio -> (B, n_mels, frames), fp32; bf16 for a bf16 x (the filterbank
    product and the log in bf16, as the JAX package casts its filterbank to the magnitudes' dtype)."""
    mag = stft_magnitude(x, n_fft=n_fft, hop_length=hop_length, win_length=win_length)
    fb = torch.as_tensor(mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max), device=x.device).to(mag.dtype)
    mel = torch.einsum("bft,fm->bmt", mag, fb)
    return torch.log(torch.clamp(mel, min=1e-5))


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Overlap-add (B, F, N) frames at ``hop_length`` -> (B, (F - 1) * hop + N).

    Each frame is cut into ceil(N / hop) hop-long parts; part j of every frame
    lands j hops later, so the sum is ceil(N / hop) shifted adds."""
    b, f, n = frames.shape
    r = -(-n // hop_length)
    parts = F.pad(frames, (0, r * hop_length - n)).reshape(b, f, r, hop_length)
    total = frames.new_zeros(b, (f - 1 + r) * hop_length)
    for j in range(r):
        total[:, j * hop_length : (j + f) * hop_length] += parts[:, :, j, :].reshape(b, f * hop_length)
    return total[:, : (f - 1) * hop_length + n]


def istft_same(re: torch.Tensor, im: torch.Tensor, window: torch.Tensor, *, n_fft: int, hop_length: int,
               win_length: int, frame_lengths=None) -> torch.Tensor:
    """Vocos-style "same"-padding iSTFT: (B, n_fft // 2 + 1, F) real and imaginary parts -> (B, F * hop), fp32.

    ``window``: the fp32 Hann window of ``win_length`` (``hann_window``) on
    re's device, which the caller keeps there (Vocos' head holds it as a
    buffer), so that no call copies it from the host.
    irfft per frame, times the window, overlap-add, divided by the
    window-square envelope, trimmed by (win - hop) // 2 at both ends.
    ``frame_lengths`` (B,): frames past each item's count are zeroed and its
    envelope sums its own frames only, so row i equals the iSTFT of its first
    ``frame_lengths[i]`` frames alone over those frames' samples."""
    if win_length != n_fft:
        raise NotImplementedError("istft_same requires win_length == n_fft")
    b, bins, f = re.shape
    im = im.float().clone()
    im[:, 0] = 0.0  # the imaginary parts of the DC and Nyquist bins take no part, as in irfft's basis
    if n_fft % 2 == 0:
        im[:, -1] = 0.0
    frames = torch.fft.irfft(torch.complex(re.float(), im), n=n_fft, dim=1).transpose(1, 2)  # (B, F, n_fft)
    frames = frames * window
    win_sq = (window * window).expand(1, f, n_fft)
    if frame_lengths is not None:
        lens = torch.as_tensor(frame_lengths, device=re.device)
        fmask = (torch.arange(f, device=re.device)[None, :] < lens[:, None]).float()[..., None]
        frames = frames * fmask
        win_sq = win_sq * fmask
    y = overlap_add(frames, hop_length) / torch.clamp(overlap_add(win_sq.contiguous(), hop_length), min=1e-11)
    pad = (win_length - hop_length) // 2
    return y[:, pad : pad + (f - 1) * hop_length + win_length - 2 * pad]
