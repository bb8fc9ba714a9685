"""Ogg/Vorbis decode and encode through the system codec libraries.

A copy of ``vocoder_tpu/data/ogg.py``.  ``read_ogg`` tries, in order, the
host library's whole-file loop (``data/native.py``), libvorbisfile's pull
API over ctypes (ov_fopen/ov_read_float), then the Vorbis I decoder in
numpy (``data/vorbis.py``) with a one-time warning that it is slow, so
``.ogg`` is always decodable; encoding (libvorbisenc + libogg, used for
fixtures) needs the libraries.

ABI notes: every opaque struct (OggVorbis_File, ogg_stream_state,
vorbis_dsp_state, vorbis_block) is allocated as an oversized byte blob —
the libraries only require correctly-ALIGNED caller memory of at least the
struct size; only vorbis_info / ogg_page / ogg_packet field layouts are
declared, and those are frozen public ABI (xiph.org headers, unchanged
since libvorbis 1.0 / libogg 1.0).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_vorbisfile = None
_warned_pure = False
_vorbis = None
_vorbisenc = None
_ogg = None


class _VorbisInfo(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
        ("bitrate_upper", ctypes.c_long),
        ("bitrate_nominal", ctypes.c_long),
        ("bitrate_lower", ctypes.c_long),
        ("bitrate_window", ctypes.c_long),
        ("codec_setup", ctypes.c_void_p),
    ]


class _OggPage(ctypes.Structure):
    _fields_ = [
        ("header", ctypes.POINTER(ctypes.c_ubyte)),
        ("header_len", ctypes.c_long),
        ("body", ctypes.POINTER(ctypes.c_ubyte)),
        ("body_len", ctypes.c_long),
    ]


class _OggPacket(ctypes.Structure):
    _fields_ = [
        ("packet", ctypes.POINTER(ctypes.c_ubyte)),
        ("bytes", ctypes.c_long),
        ("b_o_s", ctypes.c_long),
        ("e_o_s", ctypes.c_long),
        ("granulepos", ctypes.c_int64),
        ("packetno", ctypes.c_int64),
    ]


class _VorbisComment(ctypes.Structure):
    _fields_ = [
        ("user_comments", ctypes.POINTER(ctypes.c_char_p)),
        ("comment_lengths", ctypes.POINTER(ctypes.c_int)),
        ("comments", ctypes.c_int),
        ("vendor", ctypes.c_char_p),
    ]


def _blob(size: int = 8192):
    """Oversized zeroed struct memory for an opaque C type (16-byte aligned)."""
    return ctypes.create_string_buffer(size)


from vocoder_tpu_torch.data.mp3 import _load  # shared CDLL-probing helper


def _libs():
    """Load + prototype the four xiph libraries once."""
    global _vorbisfile, _vorbis, _vorbisenc, _ogg
    if _vorbisfile is not None:
        return (_vorbisfile or None, _vorbis or None, _vorbisenc or None, _ogg or None)
    c = ctypes
    vf = _load(("libvorbisfile.so.3", "libvorbisfile.so"))
    vo = _load(("libvorbis.so.0", "libvorbis.so"))
    ve = _load(("libvorbisenc.so.2", "libvorbisenc.so"))
    og = _load(("libogg.so.0", "libogg.so"))
    if vf is None or vo is None:
        _vorbisfile = _vorbis = _vorbisenc = _ogg = False
        return (None, None, None, None)

    vf.ov_fopen.restype = c.c_int
    vf.ov_fopen.argtypes = [c.c_char_p, c.c_void_p]
    vf.ov_info.restype = c.POINTER(_VorbisInfo)
    vf.ov_info.argtypes = [c.c_void_p, c.c_int]
    vf.ov_read_float.restype = c.c_long
    vf.ov_read_float.argtypes = [
        c.c_void_p,
        c.POINTER(c.POINTER(c.POINTER(c.c_float))),
        c.c_int,
        c.POINTER(c.c_int),
    ]
    vf.ov_clear.restype = c.c_int
    vf.ov_clear.argtypes = [c.c_void_p]
    vf.ov_pcm_seek.restype = c.c_int
    vf.ov_pcm_seek.argtypes = [c.c_void_p, c.c_int64]

    if ve is not None and og is not None:
        vo.vorbis_info_init.restype = None
        vo.vorbis_info_init.argtypes = [c.c_void_p]
        vo.vorbis_info_clear.restype = None
        vo.vorbis_info_clear.argtypes = [c.c_void_p]
        vo.vorbis_comment_init.restype = None
        vo.vorbis_comment_init.argtypes = [c.c_void_p]
        vo.vorbis_comment_clear.restype = None
        vo.vorbis_comment_clear.argtypes = [c.c_void_p]
        vo.vorbis_analysis_init.restype = c.c_int
        vo.vorbis_analysis_init.argtypes = [c.c_void_p, c.c_void_p]
        vo.vorbis_block_init.restype = c.c_int
        vo.vorbis_block_init.argtypes = [c.c_void_p, c.c_void_p]
        vo.vorbis_analysis_headerout.restype = c.c_int
        vo.vorbis_analysis_headerout.argtypes = [c.c_void_p, c.c_void_p] + [c.c_void_p] * 3
        vo.vorbis_analysis_buffer.restype = c.POINTER(c.POINTER(c.c_float))
        vo.vorbis_analysis_buffer.argtypes = [c.c_void_p, c.c_int]
        vo.vorbis_analysis_wrote.restype = c.c_int
        vo.vorbis_analysis_wrote.argtypes = [c.c_void_p, c.c_int]
        vo.vorbis_analysis_blockout.restype = c.c_int
        vo.vorbis_analysis_blockout.argtypes = [c.c_void_p, c.c_void_p]
        vo.vorbis_analysis.restype = c.c_int
        vo.vorbis_analysis.argtypes = [c.c_void_p, c.c_void_p]
        vo.vorbis_bitrate_addblock.restype = c.c_int
        vo.vorbis_bitrate_addblock.argtypes = [c.c_void_p]
        vo.vorbis_bitrate_flushpacket.restype = c.c_int
        vo.vorbis_bitrate_flushpacket.argtypes = [c.c_void_p, c.c_void_p]
        vo.vorbis_block_clear.restype = c.c_int
        vo.vorbis_block_clear.argtypes = [c.c_void_p]
        vo.vorbis_dsp_clear.restype = None
        vo.vorbis_dsp_clear.argtypes = [c.c_void_p]

        ve.vorbis_encode_init_vbr.restype = c.c_int
        ve.vorbis_encode_init_vbr.argtypes = [c.c_void_p, c.c_long, c.c_long, c.c_float]

        og.ogg_stream_init.restype = c.c_int
        og.ogg_stream_init.argtypes = [c.c_void_p, c.c_int]
        og.ogg_stream_packetin.restype = c.c_int
        og.ogg_stream_packetin.argtypes = [c.c_void_p, c.c_void_p]
        og.ogg_stream_flush.restype = c.c_int
        og.ogg_stream_flush.argtypes = [c.c_void_p, c.POINTER(_OggPage)]
        og.ogg_stream_pageout.restype = c.c_int
        og.ogg_stream_pageout.argtypes = [c.c_void_p, c.POINTER(_OggPage)]
        og.ogg_stream_clear.restype = c.c_int
        og.ogg_stream_clear.argtypes = [c.c_void_p]

    _vorbisfile, _vorbis, _vorbisenc, _ogg = vf, vo, (ve or False), (og or False)
    return (vf, vo, ve, og)


def decoder_available() -> bool:
    """.ogg is ALWAYS decodable: libvorbisfile when present, else the
    self-contained spec decoder (data/vorbis.py) — so ogg corpora never
    silently drop out of DECODABLE_EXTENSIONS on images without the xiph
    .so's.  system_decoder_available() reports the fast path."""
    return True


def system_decoder_available() -> bool:
    return _libs()[0] is not None


def encoder_available() -> bool:
    libs = _libs()
    return all(x is not None for x in libs)


def read_ogg(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode an Ogg/Vorbis file -> (float32 (channels, T), sample_rate).

    Raises ValueError on corrupt streams (counted-fallback semantics, like
    FLAC/mp3).  The host library's C++ loop decodes the whole file in one
    foreign call that holds no Python lock, so the data threads add up; the
    ctypes pull loop below, its fallback, holds the lock between its small
    ov_read_float calls; without libvorbisfile, ``vorbis.read_ogg_pure``.
    """
    from vocoder_tpu_torch.data import native

    got = native.ogg_decode(path)
    if got is not None:
        return got

    vf, _, _, _ = _libs()
    if vf is None:
        global _warned_pure
        if not _warned_pure:
            _warned_pure = True
            import logging

            logging.getLogger(__name__).warning(
                "libvorbisfile not found: decoding .ogg with the pure-Python "
                "spec decoder, which is far slower than the native loop. "
                "Install libvorbisfile for training-rate ingest."
            )
        from vocoder_tpu_torch.data.vorbis import read_ogg_pure

        return read_ogg_pure(path)
    return read_ogg_pull(path)


def read_ogg_pull(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode an Ogg/Vorbis file with libvorbisfile's pull loop over ctypes (RuntimeError without it)."""
    vf, _, _, _ = _libs()
    if vf is None:
        raise RuntimeError("libvorbisfile is not available")
    ovf = _blob()
    rc = vf.ov_fopen(str(path).encode(), ovf)
    if rc != 0:
        raise ValueError(f"{path}: not a decodable Ogg/Vorbis stream (ov_fopen rc={rc})")
    try:
        # On seekable CHAINED streams ov_fopen's chain scan can leave the
        # cursor at the last link; without this seek the pull loop silently
        # drops every earlier link (found by the data/vorbis.py parity tests).
        vf.ov_pcm_seek(ovf, 0)  # best-effort: nonzero rc keeps current pos
        info = vf.ov_info(ovf, -1)
        if not info:
            raise ValueError(f"{path}: ov_info failed")
        channels, rate = int(info.contents.channels), int(info.contents.rate)
        if channels <= 0 or rate <= 0:
            raise ValueError(f"{path}: bad vorbis stream info ({channels} ch, {rate} Hz)")
        pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        bitstream = ctypes.c_int(0)
        chunks: list[np.ndarray] = []
        while True:
            n = vf.ov_read_float(ovf, ctypes.byref(pcm), 4096, ctypes.byref(bitstream))
            if n == 0:
                break
            if n < 0:  # hole/corrupt section: fail loudly, not silently
                raise ValueError(f"{path}: corrupt vorbis stream (ov_read_float rc={n})")
            # Chained streams can change format mid-file; ov_read_float decodes
            # across links transparently, so re-check the CURRENT link before
            # dereferencing pcm with the first link's channel count (fewer
            # channels would read an invalid pointer — a crash, not an error).
            li = vf.ov_info(ovf, bitstream.value)
            if not li:
                # A NULL info for the current link means we cannot verify the
                # format; dereferencing pcm with the first link's channel
                # count would be the exact invalid-pointer crash the guard
                # exists to prevent — fail loudly instead.
                raise ValueError(f"{path}: ov_info failed for bitstream link {bitstream.value}")
            if int(li.contents.channels) != channels or int(li.contents.rate) != rate:
                raise ValueError(
                    f"{path}: chained Ogg stream changes format mid-file "
                    f"({channels}ch@{rate} -> {int(li.contents.channels)}ch@{int(li.contents.rate)}); unsupported"
                )
            frame = np.empty((channels, n), np.float32)
            for ch in range(channels):
                frame[ch] = np.ctypeslib.as_array(pcm[ch], shape=(n,))
            chunks.append(frame)
        if not chunks:
            raise ValueError(f"{path}: no decodable vorbis frames")
        return np.concatenate(chunks, axis=1), rate
    finally:
        vf.ov_clear(ovf)


def write_ogg(path: str | Path, audio: np.ndarray, sample_rate: int, quality: float = 0.6) -> None:
    """Encode float32 audio (T,) or (channels, T) in [-1, 1] as Ogg/Vorbis VBR."""
    vf, vo, ve, og = _libs()
    if not (vo and ve and og):
        raise RuntimeError("libvorbis/libvorbisenc/libogg not all available; cannot encode ogg")
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    n_ch, n = int(audio.shape[0]), int(audio.shape[1])

    vi = _blob()
    vo.vorbis_info_init(vi)
    cleanup = [lambda: vo.vorbis_info_clear(vi)]
    try:
        if ve.vorbis_encode_init_vbr(vi, n_ch, sample_rate, ctypes.c_float(quality)) != 0:
            raise ValueError(f"vorbis rejected encode params (sr={sample_rate}, ch={n_ch})")
        vc = _VorbisComment()
        vo.vorbis_comment_init(ctypes.byref(vc))
        cleanup.append(lambda: vo.vorbis_comment_clear(ctypes.byref(vc)))
        vd = _blob()
        if vo.vorbis_analysis_init(vd, vi) != 0:
            raise ValueError("vorbis_analysis_init failed")
        cleanup.append(lambda: vo.vorbis_dsp_clear(vd))
        vb = _blob()
        vo.vorbis_block_init(vd, vb)
        cleanup.append(lambda: vo.vorbis_block_clear(vb))
        os_ = _blob()
        og.ogg_stream_init(os_, 1)
        cleanup.append(lambda: og.ogg_stream_clear(os_))

        out = bytearray()
        page = _OggPage()

        def drain(flush: bool):
            fn = og.ogg_stream_flush if flush else og.ogg_stream_pageout
            while fn(os_, ctypes.byref(page)) != 0:
                out.extend(ctypes.string_at(page.header, page.header_len))
                out.extend(ctypes.string_at(page.body, page.body_len))

        hdr, hdr_comm, hdr_code = _OggPacket(), _OggPacket(), _OggPacket()
        vo.vorbis_analysis_headerout(
            vd, ctypes.byref(vc), ctypes.byref(hdr), ctypes.byref(hdr_comm), ctypes.byref(hdr_code)
        )
        for p in (hdr, hdr_comm, hdr_code):
            og.ogg_stream_packetin(os_, ctypes.byref(p))
        drain(flush=True)  # headers must end their own page

        pkt = _OggPacket()

        def pump():
            while vo.vorbis_analysis_blockout(vd, vb) == 1:
                vo.vorbis_analysis(vb, None)
                vo.vorbis_bitrate_addblock(vb)
                while vo.vorbis_bitrate_flushpacket(vd, ctypes.byref(pkt)) == 1:
                    og.ogg_stream_packetin(os_, ctypes.byref(pkt))
                    drain(flush=False)

        chunk = 4096
        for start in range(0, n, chunk):
            m = min(chunk, n - start)
            buf = vo.vorbis_analysis_buffer(vd, m)
            for ch in range(n_ch):
                ctypes.memmove(
                    buf[ch],
                    np.ascontiguousarray(audio[ch, start : start + m]).ctypes.data,
                    m * 4,
                )
            vo.vorbis_analysis_wrote(vd, m)
            pump()
        vo.vorbis_analysis_wrote(vd, 0)  # EOS
        pump()
        drain(flush=True)
        Path(path).write_bytes(bytes(out))
    finally:
        for fn in reversed(cleanup):
            try:
                fn()
            except Exception:
                pass
