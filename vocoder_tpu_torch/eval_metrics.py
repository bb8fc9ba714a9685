"""Objective audio metrics: PESQ, SI-SDR and MCD.

Counterpart of ``vocoder_tpu/eval_metrics.py``.  PESQ runs through the ITU
C extension when it imports and otherwise through the port's copy of the
P.862 implementation (``pesq_native.py``), with a one-time note; SI-SDR is
numpy; MCD takes the log-mel of ``ops/spectral.py`` on a given device.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

_warned_native_pesq = False


def pesq(reference: np.ndarray, estimate: np.ndarray, sample_rate: int, mode: str = "wb") -> float:
    """PESQ MOS-LQO (P.862.1 nb / P.862.2 wb); inputs already at 8 kHz (nb) / 16 kHz (wb)."""
    global _warned_native_pesq
    try:
        from pesq import pesq as _itu_pesq  # the ITU C extension, where installed

        return float(_itu_pesq(sample_rate, np.asarray(reference), np.asarray(estimate), mode))
    except ImportError:
        from vocoder_tpu_torch.pesq_native import pesq as _native_pesq

        if not _warned_native_pesq:
            _warned_native_pesq = True
            print(
                "note: PESQ computed by the in-repo P.862 implementation "
                "(vocoder_tpu_torch/pesq_native.py) — the ITU C extension is not "
                "installed. Scores are on the MOS-LQO scale and pinned by "
                "golden fixtures, but are not bit-comparable to ITU-extension "
                "numbers.",
                file=sys.stderr,
            )
        return float(_native_pesq(reference, estimate, sample_rate, mode))


def si_sdr(reference: np.ndarray, estimate: np.ndarray, eps: float = 1e-8) -> float:
    """Scale-invariant SDR in dB; inputs (T,) aligned."""
    s = np.asarray(reference, np.float64)
    x = np.asarray(estimate, np.float64)
    s = s - s.mean()
    x = x - x.mean()
    alpha = np.dot(x, s) / (np.dot(s, s) + eps)
    target = alpha * s
    noise = x - target
    return float(10.0 * np.log10((np.sum(target**2) + eps) / (np.sum(noise**2) + eps)))


@functools.lru_cache(maxsize=None)
def _dct_matrix(n_mels: int, n_mfcc: int) -> np.ndarray:
    # Orthonormal DCT-II (type 2, norm='ortho'), rows = coefficients.
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[:, None]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_mels))
    m[0] *= 1.0 / np.sqrt(2)
    return (m * np.sqrt(2.0 / n_mels)).astype(np.float64)


# The offline analyzer of the reference's eval.py:55: 1024 fft / 1024 window / 256 hop / 128 mels.
ANALYZER = dict(n_fft=1024, win_length=1024, hop_length=256, n_mels=128)


def eval_log_mel(audio: np.ndarray, sample_rate: int, device: str | torch.device = "cpu") -> np.ndarray:
    """The analyzer's log-mel of (T,) audio on ``device`` -> (128, frames) float32 on the host."""
    from vocoder_tpu_torch.ops.spectral import log_mel_spectrogram

    x = torch.as_tensor(np.asarray(audio, np.float32)[None], device=device)
    return log_mel_spectrogram(x, sample_rate=sample_rate, **ANALYZER)[0].cpu().numpy()


def mcd(reference: np.ndarray, estimate: np.ndarray, sample_rate: int, n_mfcc: int = 13,
        device: str | torch.device = "cpu") -> float:
    """Mel-cepstral distortion (dB) over log-mel DCT coefficients 1..n_mfcc.

    The analyzer's slaney log-mel (computed on ``device``), c0 (energy)
    excluded, the per-frame Euclidean distance averaged with the
    10*sqrt(2)/ln(10) constant.
    """
    a = eval_log_mel(reference, sample_rate, device)
    b = eval_log_mel(estimate, sample_rate, device)
    d = _dct_matrix(128, n_mfcc + 1)
    ca = (d @ a)[1:]  # (n_mfcc, frames), drop c0
    cb = (d @ b)[1:]
    const = 10.0 * np.sqrt(2.0) / np.log(10.0)
    return float(const * np.mean(np.sqrt(np.sum((ca - cb) ** 2, axis=0))))
