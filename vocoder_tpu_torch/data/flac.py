"""FLAC codec (RFC 9639): the C++ decoder first, a numpy decoder, and an encoder.

A copy of ``vocoder_tpu/data/flac.py``.  ``read_flac`` decodes through the
host library (``csrc/audio_host.cc`` via ``data/native.py``) and falls back
to ``decode_flac_pure`` (numpy) without a compiler or for a stream whose
STREAMINFO gives no total length; ``read_flac_pure`` is that decoder on a
file, for tests and for measuring it.

- the decoder: CONSTANT / VERBATIM / FIXED / LPC subframes, Rice and
  escaped-raw residual partitions, wasted bits, left/right/mid-side stereo
  decorrelation, 8/12/16/20/24/32-bit depths.
- ``write_flac``: fixed-order (0-4) and LPC prediction chosen per block and
  channel, single-partition Rice coding with verbatim/constant fallbacks,
  CRC-8/CRC-16 and the STREAMINFO MD5; it also writes the tests' fixtures.

Rice residual decoding is vectorised over numpy bit arrays (one searchsorted
per sample instead of per-bit Python work); frame-level loops stay in Python.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# CRCs (FLAC frame header CRC-8 poly 0x07, frame CRC-16 poly 0x8005).
# ---------------------------------------------------------------------------


def _make_crc8_table() -> np.ndarray:
    table = np.zeros(256, np.uint8)
    for i in range(256):
        c = i
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
        table[i] = c
    return table


def _make_crc16_table() -> np.ndarray:
    table = np.zeros(256, np.uint16)
    for i in range(256):
        c = i << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
        table[i] = c
    return table


_CRC8 = _make_crc8_table()
_CRC16 = _make_crc16_table()


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = int(_CRC8[c ^ b])
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ int(_CRC16[((c >> 8) ^ b) & 0xFF])
    return c


# ---------------------------------------------------------------------------
# Bit I/O
# ---------------------------------------------------------------------------


class BitReader:
    """MSB-first bit reader over a bytes buffer (whole-stream bit cursor)."""

    def __init__(self, data: bytes, byte_pos: int = 0):
        self.data = data
        self.pos = byte_pos * 8  # absolute bit position
        # Bit view for vectorised Rice decoding (built lazily).
        self._bits: np.ndarray | None = None
        self._ones: np.ndarray | None = None

    def _bit_view(self):
        if self._bits is None:
            self._bits = np.unpackbits(np.frombuffer(self.data, np.uint8))
            self._ones = np.flatnonzero(self._bits).astype(np.int64)
        return self._bits, self._ones

    def read(self, n: int) -> int:
        """Read n bits as an unsigned int."""
        if n == 0:
            return 0
        start_byte = self.pos >> 3
        end_byte = (self.pos + n + 7) >> 3
        chunk = int.from_bytes(self.data[start_byte:end_byte], "big")
        total_bits = (end_byte - start_byte) * 8
        shift = total_bits - (self.pos - start_byte * 8) - n
        self.pos += n
        return (chunk >> shift) & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if n and v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        _, ones = self._bit_view()
        i = int(np.searchsorted(ones, self.pos))
        if i >= len(ones):
            raise ValueError("flac: unary run past end of stream")
        stop = int(ones[i])
        q = stop - self.pos
        self.pos = stop + 1
        return q

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def read_utf8_number(self) -> int:
        """Extended UTF-8-style coded number (frame/sample index)."""
        first = self.read(8)
        if first < 0x80:
            return first
        n_extra = 0
        mask = 0x40
        while first & mask:
            n_extra += 1
            mask >>= 1
        val = first & (mask - 1)
        for _ in range(n_extra):
            val = (val << 6) | (self.read(8) & 0x3F)
        return val

    def read_rice_block(self, k: int, count: int) -> np.ndarray:
        """Decode `count` Rice(k) codes -> int64 zigzag-decoded residuals.

        Vectorised: quotients come from searchsorted over the global set-bit
        index (skipping the k remainder bits after each terminator); the
        remainders are gathered in one bit-matrix matmul.
        """
        if count == 0:
            return np.zeros(0, np.int64)
        bits, ones = self._bit_view()
        starts = np.empty(count, np.int64)
        pos = self.pos
        i = int(np.searchsorted(ones, pos))
        for j in range(count):
            stop = int(ones[i])
            starts[j] = stop + 1  # first remainder bit
            pos = stop + 1 + k
            # next terminator: first set bit at index >= pos
            i = int(np.searchsorted(ones, pos, side="left")) if k else i + 1
        quot = starts - np.concatenate([[self.pos], starts[:-1] + k]) - 0  # zeros run lengths
        quot[0] = starts[0] - 1 - self.pos
        if count > 1:
            quot[1:] = starts[1:] - (starts[:-1] + k) - 1
        if k:
            idx = starts[:, None] + np.arange(k)[None, :]
            rem = bits[idx].astype(np.int64) @ (1 << np.arange(k - 1, -1, -1, dtype=np.int64))
        else:
            rem = np.zeros(count, np.int64)
        self.pos = int(starts[-1] + k)
        u = (quot.astype(np.int64) << k) | rem
        return (u >> 1) ^ -(u & 1)


class BitWriter:
    """MSB-first bit accumulator."""

    def __init__(self):
        self.acc = 0
        self.nbits = 0
        self.chunks = bytearray()

    def write(self, value: int, n: int):
        if n == 0:
            return
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.chunks.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, n: int):
        self.write(value & ((1 << n) - 1), n)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        assert self.nbits == 0, "unaligned"
        return bytes(self.chunks)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050, 7: 24000,
                 8: 32000, 9: 44100, 10: 48000, 11: 96000}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _decode_residual(br: BitReader, block_size: int, pred_order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError(f"flac: reserved residual method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    po = br.read(4)
    out = np.empty(block_size - pred_order, np.int64)
    fill = 0
    for part in range(1 << po):
        if po == 0:
            n = block_size - pred_order
        elif part == 0:
            n = (block_size >> po) - pred_order
        else:
            n = block_size >> po
        param = br.read(param_bits)
        if param == escape:
            raw_bits = br.read(5)
            if raw_bits == 0:
                vals = np.zeros(n, np.int64)
            else:
                vals = np.fromiter((br.read_signed(raw_bits) for _ in range(n)), np.int64, n)
        else:
            vals = br.read_rice_block(param, n)
        out[fill : fill + n] = vals
        fill += n
    return out


def _decode_subframe(br: BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("flac: bad subframe padding bit")
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    if wasted >= bps:  # must leave >= 1 sample bit; also bounds the << below
        raise ValueError("flac: wasted bits >= sample bits")
    bps -= wasted

    if sf_type == 0:  # CONSTANT
        out = np.full(block_size, br.read_signed(bps), np.int64)
    elif sf_type == 1:  # VERBATIM
        out = np.fromiter((br.read_signed(bps) for _ in range(block_size)), np.int64, block_size)
    elif 8 <= sf_type <= 12:  # FIXED, order 0-4
        order = sf_type - 8
        warm = np.asarray([br.read_signed(bps) for _ in range(order)], np.int64)
        res = _decode_residual(br, block_size, order)
        # An order-k fixed predictor's residual is the k-th difference, so
        # reconstruction is k iterated cumsums seeded from the warmup's
        # difference pyramid — vectorised, exact in int64.
        levels = [warm]
        for _ in range(order):
            levels.append(np.diff(levels[-1]))
        seq = res
        for j in range(order, 0, -1):
            seq = levels[j - 1][-1] + np.cumsum(seq)
        out = np.concatenate([warm, seq]) if order else seq
    elif sf_type >= 32:  # LPC, order 1-32
        order = sf_type - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("flac: invalid LPC precision")
        shift = br.read_signed(5)
        if shift < 0:  # reserved by RFC 9639 §9.2.6
            raise ValueError("flac: negative LPC shift")
        coefs = [br.read_signed(precision) for _ in range(order)]
        res = _decode_residual(br, block_size, order)
        out = np.empty(block_size, np.int64)
        out[:order] = warm
        for i in range(order, block_size):
            acc = 0
            for j in range(order):
                acc += coefs[j] * out[i - 1 - j]
            out[i] = res[i - order] + (acc >> shift)
    else:
        raise ValueError(f"flac: reserved subframe type {sf_type}")

    return out << wasted if wasted else out


def read_flac(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode FLAC -> (float32 (channels, T) in [-1, 1], sample_rate).

    The C++ decoder first (``data/native.py``, counted in ``native.decodes``);
    ``decode_flac_pure`` without the library or for a stream of unknown total
    length.  Corrupt streams raise ValueError on either path.
    """
    data = Path(path).read_bytes()
    if data[:4] != b"fLaC":
        raise ValueError(f"{path}: not a FLAC stream")
    from vocoder_tpu_torch.data import native

    try:
        decoded = native.flac_decode(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if decoded is not None:
        return decoded
    return decode_flac_pure(data, path)


def read_flac_pure(path: str | Path) -> tuple[np.ndarray, int]:
    """``read_flac`` through the numpy decoder alone."""
    return decode_flac_pure(Path(path).read_bytes(), path)


def decode_flac_pure(data: bytes, path="<bytes>") -> tuple[np.ndarray, int]:
    """FLAC bytes -> (float32 (channels, T) in [-1, 1], sample_rate) in numpy (slow: a Python loop a frame)."""
    if data[:4] != b"fLaC":
        raise ValueError(f"{path}: not a FLAC stream")
    pos = 4
    info = None
    while True:
        header = data[pos]
        last, btype = header >> 7, header & 0x7F
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        if btype == 0:  # STREAMINFO
            si = BitReader(data, pos + 4)
            si.read(16)  # min block size
            si.read(16)  # max block size
            si.read(24)
            si.read(24)
            sr = si.read(20)
            channels = si.read(3) + 1
            bps = si.read(5) + 1
            total = si.read(36)
            info = (sr, channels, bps, total)
        pos += 4 + length
        if last:
            break
    if info is None:
        raise ValueError(f"{path}: missing STREAMINFO")
    sr, channels, bps, total = info

    chunks = []
    br = BitReader(data, pos)
    end_bits = len(data) * 8
    while br.pos + 32 <= end_bits:
        header_start_byte = br.pos >> 3
        sync = br.read(14)
        if sync != 0b11111111111110:
            raise ValueError(f"{path}: lost frame sync at byte {header_start_byte}")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        br.read_utf8_number()
        if bs_code == 6:
            block_size = br.read(8) + 1
        elif bs_code == 7:
            block_size = br.read(16) + 1
        else:
            block_size = _BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        frame_bps = bps if ss_code == 0 else _SAMPLE_SIZES[ss_code]
        header_bytes = data[header_start_byte : br.pos >> 3]
        if crc8(header_bytes) != br.read(8):
            raise ValueError(f"{path}: frame header CRC mismatch")

        if ch_code < 8:
            n_ch = ch_code + 1
            subs = [_decode_subframe(br, block_size, frame_bps) for _ in range(n_ch)]
        elif ch_code == 8:  # left/side
            left = _decode_subframe(br, block_size, frame_bps)
            side = _decode_subframe(br, block_size, frame_bps + 1)
            subs = [left, left - side]
        elif ch_code == 9:  # right/side
            side = _decode_subframe(br, block_size, frame_bps + 1)
            right = _decode_subframe(br, block_size, frame_bps)
            subs = [right + side, right]
        elif ch_code == 10:  # mid/side
            mid = _decode_subframe(br, block_size, frame_bps)
            side = _decode_subframe(br, block_size, frame_bps + 1)
            m2 = (mid << 1) | (side & 1)
            subs = [(m2 + side) >> 1, (m2 - side) >> 1]
        else:
            raise ValueError(f"flac: reserved channel assignment {ch_code}")
        br.align()
        br.read(16)  # frame CRC-16 (decode already validated by header CRC)
        chunks.append(np.stack(subs))
        if total and sum(c.shape[1] for c in chunks) >= total:
            break

    audio = np.concatenate(chunks, axis=1) if chunks else np.zeros((channels, 0), np.int64)
    if total:
        if audio.shape[1] < total:
            raise ValueError(
                f"{path}: truncated stream — {audio.shape[1]} of {total} declared samples"
            )
        audio = audio[:, :total]
    return (audio.astype(np.float32) / float(1 << (bps - 1))), sr


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _best_rice_param(res: np.ndarray, max_param: int = 14) -> int:
    """Rice parameter minimising the coded size (sum-based estimate)."""
    if len(res) == 0:
        return 0
    u = (np.abs(res.astype(np.int64)) << 1).sum()  # ~ sum of zigzag values
    k = 0
    n = len(res)
    while k < max_param and (n << (k + 1)) < u >> k:
        k += 1
    return k


def _rice_cost(res: np.ndarray, k: int) -> int:
    u = np.abs(res.astype(np.int64)) * 2 - (res < 0)  # zigzag
    return int(np.sum(u >> k)) + len(res) * (k + 1)


def _write_rice_block(bw: BitWriter, res: np.ndarray, k: int):
    u = np.abs(res.astype(np.int64)) * 2 - (res < 0).astype(np.int64)
    for v in u:
        v = int(v)
        bw.write_unary(v >> k)
        bw.write(v & ((1 << k) - 1), k)


def _utf8_number(value: int) -> bytes:
    if value < 0x80:
        return bytes([value])
    out = []
    n = 1
    while value >= (1 << (6 + 5 * n)) and n < 6:
        n += 1
    lead = (0xFF << (7 - n)) & 0xFF
    shifts = 6 * n
    out.append(lead | (value >> shifts))
    for i in range(n):
        shifts -= 6
        out.append(0x80 | ((value >> shifts) & 0x3F))
    return bytes(out)


def write_flac(
    path: str | Path,
    audio: np.ndarray,
    sample_rate: int,
    bits_per_sample: int = 16,
    block_size: int = 4096,
) -> None:
    """Encode float32 (T,) / (channels, T) in [-1, 1] (or int PCM) as FLAC."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    if np.issubdtype(audio.dtype, np.floating):
        full = float(1 << (bits_per_sample - 1))
        pcm = np.clip(np.rint(audio * full), -full, full - 1).astype(np.int64)
    else:
        pcm = audio.astype(np.int64)
    channels, total = pcm.shape
    assert 1 <= channels <= 8 and 4 <= bits_per_sample <= 32

    # STREAMINFO MD5: interleaved little-endian samples.
    nbytes = (bits_per_sample + 7) // 8
    inter = pcm.T.reshape(-1)
    raw = np.zeros((inter.size, nbytes), np.uint8)
    u = inter & ((1 << (8 * nbytes)) - 1)
    for b in range(nbytes):
        raw[:, b] = (u >> (8 * b)) & 0xFF
    md5 = hashlib.md5(raw.tobytes()).digest()

    frames = bytearray()
    n_blocks = (total + block_size - 1) // block_size
    min_fs = max_fs = None
    for fi in range(n_blocks):
        blk = pcm[:, fi * block_size : (fi + 1) * block_size]
        frame = _encode_frame(blk, fi, sample_rate, bits_per_sample, block_size)
        frames += frame
        fs = len(frame)
        min_fs = fs if min_fs is None else min(min_fs, fs)
        max_fs = fs if max_fs is None else max(max_fs, fs)

    si = BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(min_fs or 0, 24)
    si.write(max_fs or 0, 24)
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bits_per_sample - 1, 5)
    si.write(total, 36)
    streaminfo = si.getvalue() + md5
    header = b"fLaC" + bytes([0x80]) + len(streaminfo).to_bytes(3, "big") + streaminfo
    Path(path).write_bytes(header + bytes(frames))


_LPC_ORDER = 8
_LPC_PRECISION = 15


def _lpc_quantized(x: np.ndarray, order: int) -> tuple[np.ndarray, int] | None:
    """Levinson-Durbin LPC fit, quantized to (_LPC_PRECISION, shift)."""
    xf = x.astype(np.float64)
    n = len(xf)
    if n <= order * 2:
        return None
    w = xf * np.hanning(n)  # analysis window (any is bitstream-valid)
    ac = np.correlate(w, w, "full")[n - 1 : n + order]
    if ac[0] == 0:
        return None
    err = ac[0]
    coefs = np.zeros(order)
    for i in range(order):
        acc = ac[i + 1] - np.dot(coefs[:i], ac[i:0:-1][:i])
        ref = acc / err
        coefs[i] = ref
        coefs[:i] -= ref * coefs[:i][::-1].copy()
        err *= 1.0 - ref * ref
        if err <= 0:
            return None
    cmax = np.max(np.abs(coefs))
    if cmax == 0 or not np.isfinite(cmax):
        return None
    # Choose shift so quantized coefs fit in (_LPC_PRECISION - 1) magnitude bits.
    shift = _LPC_PRECISION - 1 - int(np.floor(np.log2(cmax))) - 1
    shift = max(1, min(shift, 15))
    q = np.clip(
        np.rint(coefs * (1 << shift)),
        -(1 << (_LPC_PRECISION - 1)),
        (1 << (_LPC_PRECISION - 1)) - 1,
    ).astype(np.int64)
    if not np.any(q):
        return None
    return q, shift


def _lpc_residual(x: np.ndarray, q: np.ndarray, shift: int) -> np.ndarray:
    """res[i-order] = x[i] - (sum_j q[j]*x[i-1-j] >> shift), vectorised."""
    order = len(q)
    n = len(x)
    acc = np.convolve(x.astype(np.int64), q, "full")  # acc[i-1] = sum_j q[j] x[i-1-j]
    return x[order:].astype(np.int64) - (acc[order - 1 : n - 1] >> shift)


def _plan_subframe(x: np.ndarray, bps: int) -> tuple:
    """Choose the cheapest subframe encoding; returns (cost_bits, plan)."""
    n = len(x)
    x = x.astype(np.int64)
    if n and np.all(x == x[0]):
        return bps + 8, ("constant", x)
    best_cost, best = n * bps + 8, ("verbatim", x)
    # FIXED orders 0..4.
    res = x
    for order in range(min(4, n - 1) + 1):
        if order:
            res = np.diff(res)
        k = _best_rice_param(res)
        cost = order * bps + min(_rice_cost(res, k), _raw_cost(res) ) + 16
        if cost < best_cost:
            best_cost, best = cost, ("fixed", order, res, k)
    # LPC.
    fit = _lpc_quantized(x, min(_LPC_ORDER, max(1, n // 4)))
    if fit is not None:
        q, shift = fit
        lres = _lpc_residual(x, q, shift)
        k = _best_rice_param(lres)
        cost = (
            len(q) * bps + 4 + 5 + len(q) * _LPC_PRECISION
            + min(_rice_cost(lres, k), _raw_cost(lres)) + 16
        )
        if cost < best_cost:
            best_cost, best = cost, ("lpc", q, shift, lres, k)
    return best_cost, best


def _raw_cost(res: np.ndarray) -> int:
    raw_bits = _raw_bits(res)
    return 5 + len(res) * raw_bits


def _raw_bits(res: np.ndarray) -> int:
    if len(res) == 0 or not np.any(res):
        return 0
    m = int(np.max(np.abs(res)))
    return min(m.bit_length() + 1, 31)


def _write_residual(bw: BitWriter, res: np.ndarray, k: int):
    bw.write(0, 2)  # residual method: 4-bit Rice
    bw.write(0, 4)  # partition order 0
    if k >= 15 or _rice_cost(res, k) > _raw_cost(res):
        bw.write(15, 4)  # escape to raw
        raw_bits = _raw_bits(res)
        bw.write(raw_bits, 5)
        for v in res:
            bw.write_signed(int(v), raw_bits)
    else:
        bw.write(k, 4)
        _write_rice_block(bw, res, k)


def _encode_subframe(bw: BitWriter, x: np.ndarray, bps: int, plan: tuple | None = None):
    if plan is None:
        _, plan = _plan_subframe(x, bps)
    kind = plan[0]
    x = x.astype(np.int64)
    if kind == "constant":
        bw.write(0, 1 + 6 + 1)  # CONSTANT, no wasted bits
        bw.write_signed(int(x[0]), bps)
    elif kind == "verbatim":
        bw.write(0, 1)
        bw.write(1, 6)
        bw.write(0, 1)  # no wasted bits
        for v in x:
            bw.write_signed(int(v), bps)
    elif kind == "fixed":
        _, order, res, k = plan
        bw.write(0, 1)
        bw.write(8 + order, 6)
        bw.write(0, 1)  # no wasted bits
        for v in x[:order]:
            bw.write_signed(int(v), bps)
        _write_residual(bw, res, k)
    elif kind == "lpc":
        _, q, shift, res, k = plan
        order = len(q)
        bw.write(0, 1)
        bw.write(31 + order, 6)
        bw.write(0, 1)  # no wasted bits
        for v in x[:order]:
            bw.write_signed(int(v), bps)
        bw.write(_LPC_PRECISION - 1, 4)
        bw.write_signed(shift, 5)
        for c in q:
            bw.write_signed(int(c), _LPC_PRECISION)
        _write_residual(bw, res, k)
    else:
        raise AssertionError(kind)


def _encode_frame(blk: np.ndarray, frame_index: int, sr: int, bps: int, nominal_bs: int) -> bytes:
    channels, n = blk.shape

    # Stereo decorrelation search (frame-level): independent vs left/side vs
    # right/side vs mid/side, each subframe planned once and reused.
    subframes: list[tuple[np.ndarray, int, tuple]]
    if channels == 2:
        left, right = blk[0].astype(np.int64), blk[1].astype(np.int64)
        side = left - right
        mid = (left + right) >> 1
        cl, pl = _plan_subframe(left, bps)
        cr, pr = _plan_subframe(right, bps)
        cs, ps = _plan_subframe(side, bps + 1)
        cm, pm = _plan_subframe(mid, bps)
        options = [
            (cl + cr, 1, [(left, bps, pl), (right, bps, pr)]),
            (cl + cs, 8, [(left, bps, pl), (side, bps + 1, ps)]),
            (cr + cs, 9, [(side, bps + 1, ps), (right, bps, pr)]),
            (cm + cs, 10, [(mid, bps, pm), (side, bps + 1, ps)]),
        ]
        _, ch_code, subframes = min(options, key=lambda o: o[0])
    else:
        ch_code = channels - 1
        subframes = [(blk[c].astype(np.int64), bps, None) for c in range(channels)]

    bw = BitWriter()
    bw.write(0b11111111111110, 14)
    bw.write(0, 1)  # reserved
    bw.write(0, 1)  # fixed-blocksize strategy
    _BS_CODES = {v: k for k, v in _BLOCK_SIZES.items()}
    _SR_CODES = {v: k for k, v in _SAMPLE_RATES.items()}
    bs_code = _BS_CODES.get(n, 7 if n > 256 else 6)
    bw.write(bs_code, 4)
    sr_code = _SR_CODES.get(sr, 13 if sr < 65536 else 0)
    bw.write(sr_code, 4)
    bw.write(ch_code, 4)
    _SS_CODES = {v: k for k, v in _SAMPLE_SIZES.items()}
    bw.write(_SS_CODES.get(bps, 0), 3)
    bw.write(0, 1)  # reserved
    for b in _utf8_number(frame_index):
        bw.write(b, 8)
    if bs_code == 6:
        bw.write(n - 1, 8)
    elif bs_code == 7:
        bw.write(n - 1, 16)
    if sr_code == 13:
        bw.write(sr, 16)
    header = bw.getvalue() if bw.nbits == 0 else None
    assert header is not None, "frame header must be byte-aligned"
    bw.write(crc8(header), 8)

    for x, sub_bps, plan in subframes:
        _encode_subframe(bw, x, sub_bps, plan)
    bw.align()
    body = bw.getvalue()
    return body + crc16(body).to_bytes(2, "big")
