"""The reference's building blocks: precision, convolutions, weight norm, the anti-aliased Snake, spectra.

Published sources: weight norm (Salimans and Kingma 2016: w = g v / ||v||, the
norm over every axis but the output one); BigVGAN's anti-aliased activation
(Lee et al. 2023, after ``alias_free_torch``): a 2x upsample by a 12-tap
Kaiser-windowed sinc (cutoff 0.25, half width 0.3) with replicate padding, the
Snake ``x + sin^2(alpha x) / (beta + 1e-9)``, then the same filter as a 2x
decimating low-pass, again with replicate padding; the slaney mel scale and
filterbank (Slaney's Auditory Toolbox, as librosa computes it).
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10-bit mantissa (to nearest), as a tensor core reads its operands; the
    gradient passes through unrounded."""
    bits = t.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (rounded - t).detach()


class Precision:
    """How the reference's convolutions round their operands: ``"fp32"`` (full fp32, TF32 off) or
    ``"tf32"`` (the control: operands rounded to TF32, sums in fp32).  On a card ``active`` sets PyTorch's
    TF32 flags for the block; on the CPU, which has no TF32, the ``"tf32"`` convolutions round their
    operands themselves."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "tf32"):
            raise ValueError(f"precision {mode!r}: fp32 or tf32")
        self.mode = mode

    @contextlib.contextmanager
    def active(self):
        flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        on = self.mode == "tf32"
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
        try:
            yield self
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    def _operands(self, x, w):
        if self.mode == "tf32" and not x.is_cuda:
            return round_tf32(x), round_tf32(w)
        return x, w

    def conv1d(self, x, w, b=None, **kw):
        x, w = self._operands(x, w)
        return F.conv1d(x, w, b, **kw)

    def conv_transpose1d(self, x, w, b=None, **kw):
        x, w = self._operands(x, w)
        return F.conv_transpose1d(x, w, b, **kw)

    def conv2d(self, x, w, b=None, **kw):
        x, w = self._operands(x, w)
        return F.conv2d(x, w, b, **kw)


def weight(params: dict, name: str) -> torch.Tensor:
    """The weight-normed weight of layer ``name``: g v / ||v||, the norm over every axis but the first."""
    g = params[f"{name}.parametrizations.weight.original0"]
    v = params[f"{name}.parametrizations.weight.original1"]
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))
    return g * v / norm


def wn_shapes(name: str, out_ch: int, weight_shape: tuple, bias: bool = True) -> dict:
    """The state-dict entries of a weight-normed layer: gain (first axis kept), direction, bias."""
    g_shape = (weight_shape[0],) + (1,) * (len(weight_shape) - 1)
    out = {f"{name}.parametrizations.weight.original0": g_shape,
           f"{name}.parametrizations.weight.original1": tuple(weight_shape)}
    if bias:
        out[f"{name}.bias"] = (out_ch,)
    return out


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


@functools.lru_cache(maxsize=None)
def kaiser_sinc(cutoff: float, half_width: float, kernel_size: int) -> tuple:
    """The Kaiser-windowed sinc low-pass of ``alias_free_torch`` (even length), normalised to sum 1."""
    half = kernel_size // 2
    delta_f = 4 * half_width
    attenuation = 2.285 * (half - 1) * math.pi * delta_f + 7.95
    if attenuation > 50.0:
        beta = 0.1102 * (attenuation - 8.7)
    elif attenuation >= 21.0:
        beta = 0.5842 * (attenuation - 21) ** 0.4 + 0.07886 * (attenuation - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    time = np.arange(-half, half) + 0.5
    f = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    return tuple((f / f.sum()).tolist())


def _aa_snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    taps = torch.tensor(kaiser_sinc(0.25, 0.3, 12), dtype=x.dtype, device=x.device)
    filt = taps.view(1, 1, 12).expand(c, 1, 12)
    # UpSample1d(ratio 2, kernel 12): replicate-pad 5, transposed conv at stride 2 times 2, trim 15 a side.
    y = 2.0 * F.conv_transpose1d(F.pad(x, (5, 5), mode="replicate"), filt, stride=2, groups=c)
    y = y[..., 15:-15]
    y = y + torch.sin(alpha[None, :, None] * y) ** 2 / (beta[None, :, None] + 1e-9)
    # DownSample1d(ratio 2, kernel 12): replicate-pad 5 left and 6 right, conv at stride 2.
    return F.conv1d(F.pad(y, (5, 6), mode="replicate"), filt, stride=2, groups=c)


def aa_snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """The anti-aliased Snake of (B, C, T) x, with ``alpha`` and ``beta`` (C,) as the Snake uses them
    (already exponentiated).  ``remat``: under autograd keep only x and recompute the rest in the
    backward (``torch.utils.checkpoint``), so a training step at full size fits in memory."""
    if remat and torch.is_grad_enabled():
        return checkpoint(_aa_snake, x, alpha, beta, use_reentrant=False)
    return _aa_snake(x, alpha, beta)


@functools.lru_cache(maxsize=None)
def hann(win_length: int) -> tuple:
    """The periodic Hann window."""
    n = np.arange(win_length, dtype=np.float64)
    return tuple((0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).tolist())


def stft_magnitude(x: torch.Tensor, n_fft: int, hop: int, win: int, pad: tuple, window: str,
                   mag: str) -> torch.Tensor:
    """|STFT| of (B, T) audio -> (B, n_fft // 2 + 1, frames): reflect padding ``pad``, no centring,
    a ``window`` ("hann" or "boxcar") of ``win`` samples centred in ``n_fft``; ``mag``: "eps"
    sqrt(power + 1e-6), "clamp" sqrt(max(power, 1e-6)) or "plain" sqrt(power) (gradient 0 where the
    power is 0)."""
    if window == "hann":
        w = torch.tensor(hann(win), dtype=torch.float32, device=x.device)
    else:
        w = torch.ones(win, device=x.device)
    xp = F.pad(x[:, None, :], pad, mode="reflect")[:, 0, :]
    spec = torch.stft(xp, n_fft, hop_length=hop, win_length=win, window=w, center=False, return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2
    if mag == "eps":
        return torch.sqrt(power + 1e-6)
    if mag == "clamp":
        return torch.sqrt(torch.clamp(power, min=1e-6))
    positive = power > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, power, torch.ones_like(power))), 0.0)


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f * 3.0 / 200.0
    log = 15.0 + np.log(np.maximum(f, 1e-30) / 1000.0) / (math.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((math.log(6.4) / 27.0) * (m - 15.0)), m * 200.0 / 3.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) slaney-scale triangles from 0 Hz to Nyquist, slaney-normalised."""
    freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2.0), n_mels + 2))
    fb = np.zeros((freqs.size, n_mels))
    for m in range(n_mels):
        lo, mid, hi = pts[m], pts[m + 1], pts[m + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        fb[:, m] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (hi - lo)
    return fb.astype(np.float32)


def log_mel(x: torch.Tensor, audio_cfg: dict) -> torch.Tensor:
    """The log-mel of (B, T) audio -> (B, n_mels, frames): "same" reflect padding of (win - hop) / 2, a
    Hann window, sqrt(power + 1e-6), the slaney filterbank, log(max(mel, 1e-5))."""
    n_fft, hop, win = audio_cfg["n_fft"], audio_cfg["hop_length"], audio_cfg["win_length"]
    pad = ((win - hop) // 2, (win - hop + 1) // 2)
    mag = stft_magnitude(x, n_fft, hop, win, pad, "hann", "eps")
    fb = torch.from_numpy(mel_filterbank(audio_cfg["sampling_rate"], n_fft, audio_cfg["num_mels"])).to(x.device)
    return torch.log(torch.clamp(torch.einsum("bft,fm->bmt", mag, fb), min=1e-5))
