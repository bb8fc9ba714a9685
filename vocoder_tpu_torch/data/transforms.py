"""Host-side waveform transforms (the augmentation pipeline), numpy.

A copy of ``vocoder_tpu/data/transforms.py`` (the reference's data/transforms),
on the port's audio reader and resampler: load, HQ pitch shift (resample
trick), random loudness, random crop, pad: the transforms of the
training and validation chains.  They run on the host and feed raw audio; the spectral
features are computed on the card.

Pure functions over numpy arrays with an explicit np.random.Generator and
no global RNG state, so the same seed gives the JAX package's stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from vocoder_tpu_torch.data.audio_io import UnsupportedFormatError, read_audio
from vocoder_tpu_torch.data.resample import resample


@dataclass
class LoadAudio:
    """Decode + resample + optional mono downmix (load.py:7-29, bug B1 fixed).

    The silence fallback exists to survive CORRUPT files mid-epoch without
    killing the run (load.py:17-21 intent); it never masks an unsupported
    format — those raise at decode (and datasets reject them at
    construction).  Every fallback is counted and logged so a rotting corpus
    is visible, not silent.
    """

    sampling_rate: int = 44100
    to_mono: bool = True
    fallback_count: int = 0  # corrupt-file silence substitutions so far

    def __call__(self, rng: np.random.Generator, path: str) -> np.ndarray:
        try:
            audio, sr = read_audio(path)
        except UnsupportedFormatError:
            raise
        except Exception as e:
            # Corrupt-file fallback: 10 s of silence at the TARGET rate.
            self.fallback_count += 1
            from vocoder_tpu_torch.utils.logging import log

            log(
                f"LoadAudio: {path}: {type(e).__name__}: {e} — substituting 10 s of "
                f"silence ({self.fallback_count} fallbacks so far)"
            )
            audio, sr = np.zeros((1, self.sampling_rate * 10), np.float32), self.sampling_rate
        audio = resample(audio, sr, self.sampling_rate)
        if self.to_mono and audio.shape[0] > 1:
            audio = audio.mean(axis=0, keepdims=True)
        return audio.astype(np.float32)


@dataclass
class RandomHQPitchShift:
    """+-12 semitone pitch shift as a cheap resample (hq_pitch_shift.py:6-35).

    Duration changes; origin freq rounded down to a multiple of 100 to bound
    the polyphase window count.
    """

    probability: float = 1.0
    pitch_range: tuple[int, int] = (-12, 12)
    sampling_rate: int = 44100

    def __call__(self, rng: np.random.Generator, audio: np.ndarray) -> np.ndarray:
        if rng.random() > self.probability:
            return audio
        pitch_shift = int(rng.integers(self.pitch_range[0], self.pitch_range[1]))
        duration_shift = 2.0 ** (pitch_shift / 12)
        orig_freq = round(self.sampling_rate * duration_shift)
        orig_freq = orig_freq - (orig_freq % 100)
        return resample(audio, orig_freq, self.sampling_rate)


@dataclass
class RandomLoudness:
    """Random peak rescale into [0.1, 0.9] (loudness.py:5-26)."""

    probability: float = 1.0
    loudness_range: tuple[float, float] = (0.1, 0.9)

    def __call__(self, rng: np.random.Generator, audio: np.ndarray) -> np.ndarray:
        if rng.random() > self.probability:
            return audio
        lo, hi = self.loudness_range
        new_loudness = rng.random() * (hi - lo) + lo
        max_loudness = float(np.max(np.abs(audio)))
        return audio * (new_loudness / (max_loudness + 1e-5))


@dataclass
class RandomCrop:
    """Fixed-length random crop (crop.py:5-26)."""

    probability: float = 1.0
    crop_length: int = 44100 * 3

    def __call__(self, rng: np.random.Generator, audio: np.ndarray) -> np.ndarray:
        if rng.random() > self.probability:
            return audio
        if audio.shape[-1] <= self.crop_length:
            return audio
        start = int(rng.integers(0, audio.shape[-1] - self.crop_length))
        return audio[..., start : start + self.crop_length]


@dataclass
class Pad:
    """Centre-pad to a multiple / target length (pad.py:6-33)."""

    multiple_of: int | None = None
    target_length: int | None = None

    def __post_init__(self):
        assert (self.multiple_of is None) != (self.target_length is None)

    def __call__(self, rng: np.random.Generator, audio: np.ndarray) -> np.ndarray:
        if self.multiple_of is not None:
            pad = self.multiple_of - (audio.shape[-1] % self.multiple_of)
            if pad == self.multiple_of:
                return audio
        else:
            pad = self.target_length - audio.shape[-1]
            if pad <= 0:
                return audio
        widths = [(0, 0)] * (audio.ndim - 1) + [(pad // 2, pad - pad // 2)]
        return np.pad(audio, widths)


@dataclass
class Compose:
    """Sequential transform chain (the torch nn.Sequential analogue)."""

    transforms: list[Callable] = field(default_factory=list)

    def __call__(self, rng: np.random.Generator, x):
        for t in self.transforms:
            x = t(rng, x)
        return x


def train_transform(sampling_rate: int, hop_length: int, num_frames: int) -> Compose:
    """configs/data/dataset/vocoder-train.yaml:2-18."""
    return Compose(
        [
            LoadAudio(sampling_rate),
            RandomHQPitchShift(probability=0.5, sampling_rate=sampling_rate),
            RandomLoudness(probability=0.5),
            RandomCrop(probability=1.0, crop_length=hop_length * num_frames),
            Pad(multiple_of=hop_length),
        ]
    )


def val_transform(sampling_rate: int, hop_length: int, crop_frames: int = 1000) -> Compose:
    """configs/data/vocoder.yaml:37-46."""
    return Compose(
        [
            LoadAudio(sampling_rate),
            RandomCrop(probability=1.0, crop_length=hop_length * crop_frames),
            Pad(multiple_of=hop_length),
        ]
    )
