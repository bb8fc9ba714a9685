"""f0 estimation and the f0-template waveform, numpy on the host.

A copy of ``vocoder_tpu/data/f0.py`` (the port imports nothing of the JAX
package): the reference's RefineGAN consumes an f0-derived template waveform
but ships no f0 extractor or template synthesis, so the JAX package added them.

- ``estimate_f0``: host-side normalised-autocorrelation f0 per frame (a
  YIN-style difference function with parabolic refinement), numpy.
- ``template_from_f0``: phase-continuous sine at the frame-interpolated f0,
  zero in unvoiced frames -- the source-excitation template that RefineGAN
  and the noise convs of HiFiGAN/BigVGAN with ``use_template=True`` consume.
- ``f0_template``: the two in a row, as the inference CLI and the trainer
  build a template from audio.
"""

from __future__ import annotations

import numpy as np


def estimate_f0(
    audio: np.ndarray,
    sample_rate: int,
    hop_length: int,
    f_min: float = 50.0,
    f_max: float = 1100.0,
    frame_length: int | None = None,
    voicing_threshold: float = 0.3,
) -> np.ndarray:
    """audio (T,) -> f0 (T//hop,) in Hz; 0 where unvoiced.

    Per frame: cumulative-mean-normalised difference function (YIN) over lags
    [sr/f_max, sr/f_min], absolute-threshold pick with parabolic interpolation.
    """
    audio = np.asarray(audio, np.float64)
    t = len(audio)
    n_frames = t // hop_length
    lag_min = max(2, int(sample_rate / f_max))
    lag_max = min(int(sample_rate / f_min), t - 1)
    frame_length = frame_length or min(2 * lag_max, 2048)

    f0 = np.zeros(n_frames)
    half = frame_length // 2
    padded = np.pad(audio, (half, half + lag_max))
    for i in range(n_frames):
        center = i * hop_length + hop_length // 2 + half
        frame = padded[center - half : center + half + lag_max]
        w = frame[:frame_length]
        # Difference function d(tau) = sum (x[j] - x[j+tau])^2 via correlation.
        energy0 = np.sum(w * w)
        d = np.empty(lag_max + 1)
        d[0] = 0.0
        # Vectorised: d[tau] = e0 + e_tau - 2*corr(tau)
        csum = np.concatenate([[0.0], np.cumsum(frame * frame)])
        for tau in range(1, lag_max + 1):
            shifted = frame[tau : tau + frame_length]
            e_tau = csum[tau + frame_length] - csum[tau]
            d[tau] = energy0 + e_tau - 2.0 * np.dot(w, shifted)
        # Cumulative-mean normalisation.
        cum = np.cumsum(d[1:])
        cmnd = np.ones(lag_max + 1)
        cmnd[1:] = d[1:] * np.arange(1, lag_max + 1) / np.maximum(cum, 1e-12)
        # Absolute threshold in the valid lag band.
        band = cmnd[lag_min : lag_max + 1]
        below = np.flatnonzero(band < voicing_threshold)
        if below.size:
            k = below[0]
            # walk to the local minimum of this dip
            while k + 1 < band.size and band[k + 1] < band[k]:
                k += 1
            tau = lag_min + k
        else:
            tau = lag_min + int(np.argmin(band))
            if band.min() > 2 * voicing_threshold:
                continue  # unvoiced
        # Parabolic refinement.
        if 1 <= tau < lag_max:
            y0, y1, y2 = cmnd[tau - 1], cmnd[tau], cmnd[tau + 1]
            denom = y0 - 2 * y1 + y2
            if abs(denom) > 1e-12:
                tau = tau + 0.5 * (y0 - y2) / denom
        f0[i] = sample_rate / tau
    return f0.astype(np.float32)


def template_from_f0(f0: np.ndarray, sample_rate: int, hop_length: int, amplitude: float = 0.1) -> np.ndarray:
    """f0 (frames,) Hz -> phase-continuous sine template (frames*hop,).

    Linear per-sample f0 interpolation; unvoiced (f0 == 0) regions emit zeros
    while the phase keeps running so voiced segments stay continuous.
    """
    f0 = np.asarray(f0, np.float64)
    t = len(f0) * hop_length
    # Per-sample f0 via nearest+linear interpolation of voiced values.
    frame_pos = (np.arange(t) + 0.5) / hop_length - 0.5
    i0 = np.clip(np.floor(frame_pos).astype(int), 0, len(f0) - 1)
    i1 = np.clip(i0 + 1, 0, len(f0) - 1)
    w = np.clip(frame_pos - i0, 0.0, 1.0)
    f_samp = f0[i0] * (1 - w) + f0[i1] * w
    voiced = (f0[i0] > 0) & (f0[i1] > 0)
    phase = 2.0 * np.pi * np.cumsum(f_samp / sample_rate)
    out = np.where(voiced, amplitude * np.sin(phase), 0.0)
    return out.astype(np.float32)


def f0_template(audio: np.ndarray, sample_rate: int, hop_length: int) -> np.ndarray:
    """audio (T,) -> the f0 template (T // hop * hop,) float32: ``template_from_f0(estimate_f0(...))``."""
    return template_from_f0(estimate_f0(audio, sample_rate, hop_length), sample_rate, hop_length)
