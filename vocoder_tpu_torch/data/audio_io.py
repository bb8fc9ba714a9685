"""Audio file I/O: ``read_audio`` for WAV, FLAC, Ogg/Vorbis and MP3, WAV out, the audio-file lister.

A copy of ``vocoder_tpu/data/audio_io.py``.  WAV (PCM 8/16/24/32 and IEEE
float) is decoded here with the standard library and numpy; FLAC by
``data/flac.py`` (the host library's C++ decoder, else numpy), Ogg/Vorbis by
``data/ogg.py`` (the C++ loop, libvorbisfile's pull loop, else the numpy
Vorbis decoder) and MP3 by ``data/mp3.py`` when libmpg123 loads.  Other
audio suffixes raise ``UnsupportedFormatError``, which the datasets refuse
when they are built.
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np

AUDIO_EXTENSIONS = {".mp3", ".wav", ".flac", ".ogg", ".m4a", ".wma", ".aac", ".aiff", ".aif", ".aifc"}

# What this host can decode: WAV and FLAC always, MP3 when libmpg123 loads,
# Ogg when its decoder is available (always: the numpy decoder backs it).
DECODABLE_EXTENSIONS = {".wav", ".flac"}

try:
    from vocoder_tpu_torch.data.mp3 import decoder_available as _mp3_decodable

    if _mp3_decodable():
        DECODABLE_EXTENSIONS.add(".mp3")
except Exception:  # a broken libmpg123 must not break WAV/FLAC I/O
    pass

try:
    from vocoder_tpu_torch.data.ogg import decoder_available as _ogg_decodable

    if _ogg_decodable():
        DECODABLE_EXTENSIONS.add(".ogg")
except Exception:  # a broken libvorbisfile must not break I/O
    pass


class UnsupportedFormatError(ValueError):
    """The container format is recognised as audio but has no decoder here."""


def read_audio(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode an audio file -> (float32 (channels, T) in [-1, 1], sample_rate).

    Audio suffixes without a decoder raise UnsupportedFormatError, so that a
    caller can tell "wrong format" (fail fast) from "corrupt file" (ValueError,
    recoverable); an unknown suffix is read as RIFF/WAVE.
    """
    suffix = Path(path).suffix.lower()
    if suffix == ".flac":
        from vocoder_tpu_torch.data.flac import read_flac

        return read_flac(path)
    if suffix == ".mp3":
        if ".mp3" in DECODABLE_EXTENSIONS:
            from vocoder_tpu_torch.data.mp3 import read_mp3

            return read_mp3(path)
        raise UnsupportedFormatError(f"{path}: .mp3 needs libmpg123, which is unavailable")
    if suffix == ".ogg":
        from vocoder_tpu_torch.data.ogg import read_ogg

        return read_ogg(path)
    if suffix in DECODABLE_EXTENSIONS or suffix not in AUDIO_EXTENSIONS:
        return read_wav(path)
    raise UnsupportedFormatError(f"{path}: no decoder for {suffix!r} (supported: {sorted(DECODABLE_EXTENSIONS)})")


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (audio float32 (channels, T) in [-1, 1], sample_rate)."""
    path = str(path)
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            chunk_header = f.read(8)
            if len(chunk_header) < 8:
                break
            cid, size = struct.unpack("<4sI", chunk_header)
            if cid == b"fmt ":
                fmt = f.read(size)
            elif cid == b"data":
                data = f.read(size)
            else:
                f.seek(size + (size & 1), 1)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sr, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            x = raw[:, 0].astype(np.int32) | (raw[:, 1].astype(np.int32) << 8) | (raw[:, 2].astype(np.int32) << 16)
            x = (x << 8) >> 8  # sign-extend
            x = x.astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(data, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")

    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels).T.copy(), sr


def write_wav(path: str | Path, audio: np.ndarray, sample_rate: int) -> None:
    """Write float32 audio (T,) or (channels, T) as 16-bit PCM WAV."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    pcm = np.clip(audio.T * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(audio.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def list_audio_files(path: str | Path) -> list[Path]:
    """Every file under ``path``, recursively, with a suffix of ``AUDIO_EXTENSIONS``, sorted."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Directory {path} does not exist.")
    return sorted(p for p in path.rglob("*") if p.is_file() and p.suffix.lower() in AUDIO_EXTENSIONS)
