"""Polyphase sinc resampler (torchaudio.functional.resample semantics).

A copy of ``vocoder_tpu/data/resample.py``: sinc_interp_hann kernel,
lowpass_filter_width=6, rolloff=0.99.  1-D audio goes through the host
library's C++ kernel (``data/native.py::resample_native``, counted in
``native.resamples``) when it loaded, as the JAX package's does; other shapes,
and every shape without the library, through numpy, with the same kernel table.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from vocoder_tpu_torch.data import native


@functools.lru_cache(maxsize=None)
def _kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6, rolloff: float = 0.99):
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    scale = base_freq / orig_freq
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * window * scale
    return kernels.astype(np.float32), width  # (new_freq, taps)


def resample(x: np.ndarray, orig_sr: int, new_sr: int, lowpass_filter_width: int = 6, rolloff: float = 0.99) -> np.ndarray:
    """Resample (..., T) float32 audio from orig_sr to new_sr."""
    if orig_sr == new_sr:
        return np.asarray(x, dtype=np.float32)
    g = math.gcd(int(orig_sr), int(new_sr))
    orig_freq, new_freq = int(orig_sr) // g, int(new_sr) // g
    kernels, width = _kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    if np.ndim(x) == 1:
        out = native.resample_native(np.asarray(x, np.float32), orig_freq, new_freq, kernels, width)
        if out is not None:
            return out

    x = np.asarray(x, dtype=np.float32)
    shape = x.shape
    length = shape[-1]
    x2 = x.reshape(-1, length)
    target_length = math.ceil(new_freq * length / orig_freq)

    xp = np.pad(x2, ((0, 0), (width, width + orig_freq)))
    taps = kernels.shape[1]
    n_frames = (xp.shape[1] - taps) // orig_freq + 1
    # Strided frame view: (B, n_frames, taps), stride orig_freq.
    sv = np.lib.stride_tricks.sliding_window_view(xp, taps, axis=1)[:, ::orig_freq, :]
    sv = sv[:, :n_frames, :]
    out = np.einsum("bft,kt->bfk", sv, kernels)  # (B, n_frames, new_freq)
    out = out.reshape(x2.shape[0], -1)[:, :target_length]
    return out.reshape(shape[:-1] + (target_length,))
