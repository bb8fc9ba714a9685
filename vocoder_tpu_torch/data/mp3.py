"""MP3 (MPEG-1/2 Layer III) decode and encode through the system codec libraries.

A copy of ``vocoder_tpu/data/mp3.py``: libmpg123 (decoder) and libmp3lame
(encoder) bound over ctypes with their stable public ABI (no headers).
Without libmpg123, ``decoder_available`` is False and ``audio_io`` keeps
``.mp3`` out of ``DECODABLE_EXTENSIONS``, so a dataset with MP3 files fails
when it is built.

Decoder notes:
- output is forced to float32 via MPG123_FORCE_FLOAT, so every MPEG bit
  depth/rate decodes to the (channels, T) float contract of ``read_audio``;
- the whole file is pushed through the feed API, read until
  MPG123_NEED_MORE/DONE;
- LAME/Xing gapless metadata is honoured by mpg123 by default, so encoder
  delay/padding are trimmed and lame->mpg123 round-trips stay time-aligned.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

# --- mpg123 public ABI constants (mpg123.h) --------------------------------
_MPG123_OK = 0
_MPG123_ERR = -1
_MPG123_NEED_MORE = -10
_MPG123_NEW_FORMAT = -11
_MPG123_DONE = -12
_MPG123_ADD_FLAGS = 2  # enum mpg123_parms
_MPG123_QUIET = 0x20
_MPG123_FORCE_FLOAT = 0x400
_MPG123_ENC_FLOAT_32 = 0x200

_mpg123_lib = None
_lame_lib = None


def _load(names: tuple[str, ...]):
    """First loadable CDLL among `names`, else None (shared with ogg.py)."""
    for name in names:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


def _mpg123():
    """Load + prototype libmpg123 once; None when unavailable."""
    global _mpg123_lib
    if _mpg123_lib is not None:
        return _mpg123_lib or None
    lib = _load(("libmpg123.so.0", "libmpg123.so", "libmpg123.dylib"))
    if lib is None:
        _mpg123_lib = False
        return None
    c = ctypes
    lib.mpg123_init.restype = c.c_int
    lib.mpg123_new.restype = c.c_void_p
    lib.mpg123_new.argtypes = [c.c_char_p, c.POINTER(c.c_int)]
    lib.mpg123_delete.restype = None
    lib.mpg123_delete.argtypes = [c.c_void_p]
    lib.mpg123_param.restype = c.c_int
    lib.mpg123_param.argtypes = [c.c_void_p, c.c_int, c.c_long, c.c_double]
    lib.mpg123_open_feed.restype = c.c_int
    lib.mpg123_open_feed.argtypes = [c.c_void_p]
    lib.mpg123_feed.restype = c.c_int
    lib.mpg123_feed.argtypes = [c.c_void_p, c.c_char_p, c.c_size_t]
    lib.mpg123_read.restype = c.c_int
    lib.mpg123_read.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t, c.POINTER(c.c_size_t)]
    lib.mpg123_getformat.restype = c.c_int
    lib.mpg123_getformat.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_long),
        c.POINTER(c.c_int),
        c.POINTER(c.c_int),
    ]
    lib.mpg123_strerror.restype = c.c_char_p
    lib.mpg123_strerror.argtypes = [c.c_void_p]
    lib.mpg123_init()  # no-op on modern libmpg123, required on old ones
    _mpg123_lib = lib
    return lib


def _lame():
    """Load + prototype libmp3lame once; None when unavailable."""
    global _lame_lib
    if _lame_lib is not None:
        return _lame_lib or None
    lib = _load(("libmp3lame.so.0", "libmp3lame.so", "libmp3lame.dylib"))
    if lib is None:
        _lame_lib = False
        return None
    c = ctypes
    lib.lame_init.restype = c.c_void_p
    lib.lame_init.argtypes = []
    for setter in (
        "lame_set_in_samplerate",
        "lame_set_num_channels",
        "lame_set_brate",
        "lame_set_quality",
        "lame_set_bWriteVbrTag",
    ):
        fn = getattr(lib, setter)
        fn.restype = c.c_int
        fn.argtypes = [c.c_void_p, c.c_int]
    lib.lame_init_params.restype = c.c_int
    lib.lame_init_params.argtypes = [c.c_void_p]
    lib.lame_encode_buffer_ieee_float.restype = c.c_int
    lib.lame_encode_buffer_ieee_float.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_float),
        c.POINTER(c.c_float),
        c.c_int,
        c.c_void_p,
        c.c_int,
    ]
    lib.lame_encode_flush.restype = c.c_int
    lib.lame_encode_flush.argtypes = [c.c_void_p, c.c_void_p, c.c_int]
    lib.lame_get_lametag_frame.restype = c.c_size_t
    lib.lame_get_lametag_frame.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t]
    lib.lame_close.restype = c.c_int
    lib.lame_close.argtypes = [c.c_void_p]
    _lame_lib = lib
    return lib


def decoder_available() -> bool:
    return _mpg123() is not None


def encoder_available() -> bool:
    return _lame() is not None


def read_mp3(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode an MP3 file -> (float32 (channels, T), sample_rate).

    Raises ValueError on corrupt/empty streams (so LoadAudio's counted
    corrupt-file fallback applies, same as FLAC) and RuntimeError when the
    decoder library is missing.
    """
    lib = _mpg123()
    if lib is None:
        raise RuntimeError("libmpg123 is not available; cannot decode mp3")
    data = Path(path).read_bytes()
    err = ctypes.c_int(0)
    handle = lib.mpg123_new(None, ctypes.byref(err))
    if not handle:
        raise RuntimeError(f"mpg123_new failed (code {err.value})")
    try:
        lib.mpg123_param(handle, _MPG123_ADD_FLAGS, _MPG123_QUIET | _MPG123_FORCE_FLOAT, 0.0)
        if lib.mpg123_open_feed(handle) != _MPG123_OK:
            raise ValueError(f"{path}: mpg123_open_feed failed")
        if lib.mpg123_feed(handle, data, len(data)) != _MPG123_OK:
            raise ValueError(f"{path}: mpg123 rejected the stream")

        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        done = ctypes.c_size_t(0)
        buf = (ctypes.c_ubyte * (1 << 18))()
        chunks: list[bytes] = []
        sr = 0
        n_ch = 0
        while True:
            rc = lib.mpg123_read(handle, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(memoryview(buf)[: done.value]))
            if rc == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(
                    handle, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding)
                )
                # A second NEW_FORMAT with different params means a mid-stream
                # format change (e.g. naively concatenated MP3s): joining the
                # chunks would interleave channels wrongly and mislabel the
                # rate — silent corruption.  Fail loudly instead.
                if sr and (int(rate.value) != sr or int(channels.value) != n_ch):
                    raise ValueError(
                        f"{path}: mp3 stream changes format mid-file "
                        f"({n_ch}ch@{sr} -> {int(channels.value)}ch@{int(rate.value)}); unsupported"
                    )
                sr, n_ch = int(rate.value), int(channels.value)
                if encoding.value != _MPG123_ENC_FLOAT_32:
                    raise ValueError(f"{path}: unexpected mpg123 encoding {encoding.value:#x}")
            elif rc == _MPG123_OK:
                continue
            elif rc in (_MPG123_NEED_MORE, _MPG123_DONE):
                break  # everything fed; whatever is left is less than a frame
            else:
                msg = lib.mpg123_strerror(handle)
                raise ValueError(
                    f"{path}: mpg123 decode error: {msg.decode() if msg else rc}"
                )
        if not chunks or not sr or not n_ch:
            raise ValueError(f"{path}: no decodable mp3 frames")
        pcm = np.frombuffer(b"".join(chunks), dtype="<f4")
        n = (pcm.size // n_ch) * n_ch
        return pcm[:n].reshape(-1, n_ch).T.copy(), sr
    finally:
        lib.mpg123_delete(handle)


def write_mp3(
    path: str | Path,
    audio: np.ndarray,
    sample_rate: int,
    bitrate_kbps: int = 192,
    quality: int = 2,
) -> None:
    """Encode float32 audio (T,) or (channels, T) in [-1, 1] as CBR MP3.

    Keeps the default LAME/Xing tag so decoders (incl. :func:`read_mp3`)
    trim encoder delay/padding and the round trip stays time-aligned.
    """
    lib = _lame()
    if lib is None:
        raise RuntimeError("libmp3lame is not available; cannot encode mp3")
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    if audio.shape[0] > 2:
        raise ValueError(f"mp3 supports 1-2 channels, got {audio.shape[0]}")
    n_ch, n = int(audio.shape[0]), int(audio.shape[1])

    gfp = lib.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gfp, int(sample_rate))
        lib.lame_set_num_channels(gfp, n_ch)
        lib.lame_set_brate(gfp, int(bitrate_kbps))
        lib.lame_set_quality(gfp, int(quality))
        if lib.lame_init_params(gfp) < 0:
            raise ValueError(
                f"lame rejected the encode parameters (sr={sample_rate}, "
                f"ch={n_ch}, {bitrate_kbps} kbps)"
            )
        left = np.ascontiguousarray(audio[0])
        right = np.ascontiguousarray(audio[1]) if n_ch == 2 else left
        out = (ctypes.c_ubyte * (int(1.25 * n) + 7200))()
        fp = ctypes.POINTER(ctypes.c_float)
        n_out = lib.lame_encode_buffer_ieee_float(
            gfp, left.ctypes.data_as(fp), right.ctypes.data_as(fp), n, out, len(out)
        )
        if n_out < 0:
            raise ValueError(f"lame_encode_buffer failed (code {n_out})")
        blob = bytes(memoryview(out)[:n_out])
        n_out = lib.lame_encode_flush(gfp, out, len(out))
        if n_out < 0:
            raise ValueError(f"lame_encode_flush failed (code {n_out})")
        blob += bytes(memoryview(out)[:n_out])
        # Fill in the reserved Xing/LAME frame (frame count + encoder
        # delay/padding) so decoders can trim to the exact original length.
        tag_len = lib.lame_get_lametag_frame(gfp, out, len(out))
        if 0 < tag_len <= len(blob):
            blob = bytes(memoryview(out)[:tag_len]) + blob[tag_len:]
    finally:
        lib.lame_close(gfp)
    Path(path).write_bytes(blob)
