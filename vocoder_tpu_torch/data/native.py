"""ctypes bindings for the host audio library, ``vocoder_tpu_torch/csrc/audio_host.cc``.

The library is built at first use by the system C++ compiler (``$CXX``, else
``g++``/``c++``) with ``-O3 -fPIC -march=native -std=c++17 -shared -ldl``,
through the kernels' builder (``ops/build.compile_libraries``): into
``build/kernels/audio_host-<hash>.so`` at the repository root, named by a hash
of the source, the flags, the compiler and the host's CPU (``-march=native``
code runs only where it was built), under its file lock.  Bound as
``vocoder_tpu/data/native.py`` binds its own: FLAC (``flac_probe``/
``flac_decode``), Ogg/Vorbis (``ogg_probe``/``ogg_decode_file``), each one
foreign call a file that holds no Python lock, and the polyphase resampler of
1-D audio (``resample_poly``, ``resample_native``).

Without a compiler, or when the build fails, ``available()`` is False,
``build_error`` says why and the decoders fall back to their Python paths.
``decodes`` counts the files each native decoder returned and ``resamples`` the
signals the native resampler returned, so a caller can tell that the native
path ran (``chip_smoke.py`` requires it).
"""

from __future__ import annotations

import ctypes
import os
import platform
import shutil
import threading
import time
from pathlib import Path

import numpy as np

from vocoder_tpu_torch.ops import build

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "audio_host.cc"
CXX_FLAGS = ("-O3", "-fPIC", "-march=native", "-std=c++17", "-shared")

decodes = {"flac": 0, "ogg": 0}  # files decoded by the native library, by format
resamples = 0  # 1-D signals resampled by the native library
build_seconds: float | None = None  # this process's compile time; 0.0 when the library was already built
build_error: str | None = None

_lib = None
_tried = False
_lock = threading.Lock()


def _count(fmt: str) -> None:
    with _lock:
        decodes[fmt] += 1


def _count_resample() -> None:
    global resamples
    with _lock:
        resamples += 1


def _compiler() -> str | None:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def _cpu_id() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith(("flags", "Features")):
                return line
    except OSError:
        pass
    return platform.processor()


def _build() -> Path:
    global build_seconds
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler found (set CXX, or put g++ on PATH)")
    lib = build.Library("audio_host", CXX_FLAGS, SOURCE, link=("-ldl",),
                        host=" ".join((cxx, platform.machine(), _cpu_id())))
    built = lib.target().is_file()
    t0 = time.perf_counter()
    path = build.compile_libraries([lib], lambda: cxx)["audio_host"]
    build_seconds = 0.0 if built else time.perf_counter() - t0
    return path


def _load():
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except Exception as e:  # no compiler, a failed build, an unloadable library: the Python paths
            build_error = f"{type(e).__name__}: {e}"
            return None
        lib.flac_probe.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.flac_probe.restype = ctypes.c_int
        lib.flac_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int64, ctypes.c_void_p]
        lib.flac_decode.restype = ctypes.c_int64
        lib.ogg_probe.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.ogg_probe.restype = ctypes.c_int
        lib.ogg_decode_file.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64]
        lib.ogg_decode_file.restype = ctypes.c_int64
        lib.resample_poly.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
        lib.resample_poly.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def flac_decode(data: bytes) -> tuple[np.ndarray, int] | None:
    """FLAC bytes -> (float32 (channels, T), sample_rate) via the C++ decoder.

    Returns None when the library is unavailable or the stream needs the
    Python decoder (unknown total length); raises ValueError on corrupt
    streams, as ``data/flac.py``'s decoder does.
    """
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(5, np.int64)
    if lib.flac_probe(buf.ctypes.data, len(buf), info.ctypes.data) != 0:
        raise ValueError("not a FLAC stream")
    sr, channels, bps, total, start_bits = (int(v) for v in info)
    if total == 0:
        return None  # unknown length: the Python path handles it
    # Bound the untrusted 36-bit STREAMINFO total before allocating: even
    # all-constant silence compresses no better than a few bytes per
    # 4096-sample block.
    out_bytes = total * channels * 4
    if out_bytes > max(16384 * len(data), 1 << 20) or out_bytes > (8 << 30):
        raise ValueError(
            f"implausible FLAC STREAMINFO: {total} samples x {channels} ch declared by a {len(data)}-byte stream"
        )
    out = np.empty((channels, total), np.float32)
    got = lib.flac_decode(buf.ctypes.data, len(buf), start_bits, channels, bps, total, out.ctypes.data)
    if got < 0:
        raise ValueError(f"corrupt FLAC stream (native decoder error {got})")
    if got < total:
        raise ValueError(f"truncated stream — {got} of {total} declared samples")
    _count("flac")
    return out, sr


def ogg_decode(path) -> tuple[np.ndarray, int] | None:
    """Ogg/Vorbis file -> (float32 (channels, T), sample_rate) via the C++ decode loop.

    Returns None whenever this path cannot handle the file (library or
    libvorbisfile unavailable, undecodable, unknown or implausible length,
    chained, holey), so that the ctypes pull loop decodes it again and raises
    its own errors: the native path changes no error.
    """
    lib = _load()
    if lib is None:
        return None
    p = str(path).encode()
    info = np.zeros(3, np.int64)
    if lib.ogg_probe(p, info.ctypes.data) != 0:
        return None
    channels, rate, total = (int(v) for v in info)
    if total * channels * 4 > (8 << 30):
        return None
    out = np.empty((channels, total), np.float32)
    got = lib.ogg_decode_file(p, out.ctypes.data, channels, total)
    if got <= 0:
        return None
    _count("ogg")
    return out[:, :got], rate


def resample_native(x: np.ndarray, orig_freq: int, new_freq: int, kernels: np.ndarray, width: int) -> np.ndarray | None:
    """1-D resample through the C++ polyphase kernel, with ``data/resample.py``'s kernel table
    (new_freq, taps) and width; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    kernels = np.ascontiguousarray(kernels, np.float32)
    y_len = -(-new_freq * x.shape[-1] // orig_freq)
    y = np.empty(y_len, np.float32)
    lib.resample_poly(x.ctypes.data, x.shape[-1], kernels.ctypes.data, new_freq, orig_freq, kernels.shape[1], width,
                      y.ctypes.data, y_len)
    _count_resample()
    return y
