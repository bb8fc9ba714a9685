"""Self-contained Ogg/Vorbis decoder — a Vorbis I specification implementation.

A copy of ``vocoder_tpu/data/vorbis.py``: the fallback of ``data/ogg.py``
when libvorbisfile is absent, so ``.ogg`` stays decodable with no system
library, only slower.

Scope: the full Vorbis I decode chain as specified —
  Ogg framing (pages, CRC-32 0x04c11db7, lacing/packet assembly, grouped
  and chained streams), LSB-first bit unpacking, codebook parse (ordered +
  sparse length lists, first-fit canonical Huffman assignment, lookup
  type 1 lattice / type 2 direct VQ tables), floor type 1 (posts, neighbor
  prediction, Bresenham line render, inverse-dB table), residue types
  0/1/2 (8-pass cascade, classword partition decode, interleaved type-2),
  mapping type 0 with square-polar channel coupling, IMDCT, the
  sin(pi/2 sin^2) lapped window with long/short hybrid overlap, granule
  trimming, and end-of-packet truncation semantics.
Floor type 0 (LSP) is NOT implemented: no encoder of the last two decades
emits it and there is no way to produce a test vector here; streams using
it fail loudly with ValueError rather than decoding unverified math.

The JAX package's tests/test_vorbis_native.py holds this decoder to
libvorbisfile (sample-exact lengths, allclose PCM: libvorbis's float32 MDCT
against the float64 math here); tests/test_torch_audio_formats.py holds the
port's copy to the JAX package's.  It is clear, spec-shaped numpy, not a
fast path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# Ogg framing
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc_table() -> np.ndarray:
    """Ogg CRC-32: poly 0x04c11db7, MSB-first, init 0, no final xor."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tab = np.zeros(256, np.uint32)
        for i in range(256):
            r = i << 24
            for _ in range(8):
                r = ((r << 1) ^ 0x04C11DB7) if (r & 0x80000000) else (r << 1)
                r &= 0xFFFFFFFF
            tab[i] = r
        _CRC_TABLE = tab
    return _CRC_TABLE


def _ogg_crc(data: bytes) -> int:
    tab = _crc_table()
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFFFFFF) ^ int(tab[((c >> 24) & 0xFF) ^ b])
    return c


class OggPage:
    __slots__ = ("flags", "granule", "serial", "seq", "segments")

    def __init__(self, flags, granule, serial, seq, segments):
        self.flags = flags
        self.granule = granule
        self.serial = serial
        self.seq = seq
        self.segments = segments  # list[bytes], one per lacing value


def _parse_pages(data: bytes, path):
    """Yield OggPage for every page in `data`; validates capture + CRC."""
    pos = 0
    n = len(data)
    while pos < n:
        nxt = data.find(b"OggS", pos)
        if nxt < 0:
            return
        if nxt != pos:
            raise ValueError(f"{path}: garbage between Ogg pages at byte {pos}")
        if pos + 27 > n:
            return  # truncated header: stop at last whole page
        hdr = data[pos : pos + 27]
        if hdr[4] != 0:
            raise ValueError(f"{path}: unsupported Ogg stream structure version {hdr[4]}")
        flags = hdr[5]
        granule = int.from_bytes(hdr[6:14], "little", signed=True)
        serial = int.from_bytes(hdr[14:18], "little")
        seq = int.from_bytes(hdr[18:22], "little")
        crc = int.from_bytes(hdr[22:26], "little")
        nsegs = hdr[26]
        lace = data[pos + 27 : pos + 27 + nsegs]
        if len(lace) < nsegs:
            return
        body_len = sum(lace)
        end = pos + 27 + nsegs + body_len
        if end > n:
            return  # truncated final page
        page = data[pos:end]
        if _ogg_crc(page[:22] + b"\x00\x00\x00\x00" + page[26:]) != crc:
            raise ValueError(f"{path}: Ogg page CRC mismatch at byte {pos}")
        body = data[pos + 27 + nsegs : end]
        segments = []
        off = 0
        for v in lace:
            segments.append(body[off : off + v])
            off += v
        # lacing values are what delimit packets; keep raw values alongside
        yield OggPage(flags, granule, serial, seq, list(zip(segments, lace)))
        pos = end


def _assemble_packets(pages, path):
    """(packets, page_granules): packets as list[bytes]; page boundary info
    as list of (packet_count_through_page, granulepos) per page."""
    packets: list[bytes] = []
    partial = bytearray()
    page_marks = []
    open_packet = False
    headless = False  # the open packet's head is missing (hole/seek landing)
    for pg in pages:
        if pg.flags & 0x01:
            if not open_packet:
                headless = True
        elif open_packet:
            raise ValueError(f"{path}: packet spans pages but continuation flag missing")
        for seg, lace in pg.segments:
            partial += seg
            if lace < 255:
                if headless:
                    headless = False  # discard the head-missing fragment (spec)
                else:
                    packets.append(bytes(partial))
                partial = bytearray()
                open_packet = False
            else:
                open_packet = True
        page_marks.append((len(packets), pg.granule))
    return packets, page_marks


# ---------------------------------------------------------------------------
# Bit unpacking (LSB-first) and small helpers
# ---------------------------------------------------------------------------


class _EndOfPacket(Exception):
    pass


class BitReader:
    """LSB-first bit reader over one packet (Vorbis I §2)."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.nbits = 8 * len(data)

    def read(self, n: int) -> int:
        p = self.pos
        if p + n > self.nbits:
            self.pos = self.nbits
            raise _EndOfPacket
        self.pos = p + n
        byte0 = p >> 3
        nbytes = ((p + n - 1) >> 3) - byte0 + 1
        window = int.from_bytes(self.data[byte0 : byte0 + nbytes], "little")
        return (window >> (p & 7)) & ((1 << n) - 1)

    def peek(self, n: int) -> tuple[int, int]:
        """(value, valid_bits): up to n next bits, zero-padded past the end."""
        p = self.pos
        avail = min(n, self.nbits - p)
        if avail <= 0:
            return 0, 0
        byte0 = p >> 3
        nbytes = ((p + n - 1) >> 3) - byte0 + 1
        window = int.from_bytes(self.data[byte0 : byte0 + nbytes], "little")
        return (window >> (p & 7)) & ((1 << n) - 1), avail

    def skip(self, n: int):
        self.pos += n


def _ilog(x: int) -> int:
    """Vorbis ilog: bits needed for x (ilog(0) = 0, ilog(1) = 1)."""
    return x.bit_length() if x > 0 else 0


def _float32_unpack(x: int) -> float:
    mantissa = x & 0x1FFFFF
    if x & 0x80000000:
        mantissa = -mantissa
    exponent = (x & 0x7FE00000) >> 21
    return float(mantissa) * 2.0 ** (exponent - 788)


def _lookup1_values(entries: int, dims: int) -> int:
    """Largest v with v**dims <= entries."""
    v = int(entries ** (1.0 / dims))
    while (v + 1) ** dims <= entries:
        v += 1
    while v**dims > entries:
        v -= 1
    return v


# ---------------------------------------------------------------------------
# Codebooks
# ---------------------------------------------------------------------------

_PEEK_BITS = 11


def _assign_codewords(lengths: list[int], path) -> dict[int, int]:
    """First-fit canonical Huffman assignment (Vorbis I §3.2.1).

    Entries are assigned, in order, the lowest-valued vacant leaf at their
    depth; returns {entry: codeword} with codewords MSB-aligned to their
    length.  Raises on an over- or under-specified tree (except the
    single-entry codebook, which the spec permits to be underspecified).
    """
    used = [(i, l) for i, l in enumerate(lengths) if l > 0]
    codes: dict[int, int] = {}
    if not used:
        return codes
    if len(used) == 1:
        # Single-entry codebook: one codeword of the written length; decoders
        # consume that many bits and always return the entry.
        codes[used[0][0]] = 0
        return codes
    available = [0] * 33
    first_i, first_l = used[0]
    codes[first_i] = 0
    for j in range(1, first_l + 1):
        available[j] = 1 << (32 - j)
    for i, l in used[1:]:
        y = l
        while y > 0 and available[y] == 0:
            y -= 1
        if y == 0:
            raise ValueError(f"{path}: over-specified Huffman tree in codebook")
        res = available[y]
        available[y] = 0
        codes[i] = res >> (32 - l)
        for j in range(y + 1, l + 1):
            available[j] = res | (1 << (32 - j))
    # Under-specification check: the tree must be full.
    if any(available[1:]):
        raise ValueError(f"{path}: under-specified Huffman tree in codebook")
    return codes


_REV_TABLE = None


def _rev_table() -> np.ndarray:
    """Bit-reversal for _PEEK_BITS-bit integers (stream order -> MSB-first)."""
    global _REV_TABLE
    if _REV_TABLE is None:
        k = _PEEK_BITS
        t = np.zeros(1 << k, np.uint16)
        for v in range(1 << k):
            r = 0
            for b in range(k):
                r |= ((v >> b) & 1) << (k - 1 - b)
            t[v] = r
        _REV_TABLE = t
    return _REV_TABLE


class Codebook:
    def __init__(self, r: BitReader, path):
        if r.read(24) != 0x564342:
            raise ValueError(f"{path}: codebook sync lost")
        self.dims = r.read(16)
        self.entries = r.read(24)
        lengths = [0] * self.entries
        if r.read(1):  # ordered
            cur_len = r.read(5) + 1
            cur = 0
            while cur < self.entries:
                num = r.read(_ilog(self.entries - cur))
                if cur + num > self.entries:
                    raise ValueError(f"{path}: ordered codebook overflows entries")
                for i in range(cur, cur + num):
                    lengths[i] = cur_len
                cur += num
                cur_len += 1
        else:
            sparse = r.read(1)
            for i in range(self.entries):
                if sparse and not r.read(1):
                    continue
                lengths[i] = r.read(5) + 1
        codes = _assign_codewords(lengths, path)

        # Fast decode: flat prefix table for codes <= _PEEK_BITS bits, dict
        # keyed by (length, code) for the long tail.
        k = _PEEK_BITS
        self.fast = np.full(1 << k, -1, np.int32)
        self.fast_len = np.zeros(1 << k, np.int8)
        self.slow: dict[tuple[int, int], int] = {}
        self.max_len = 0
        for entry, code in codes.items():
            l = lengths[entry]
            self.max_len = max(self.max_len, l)
            if l <= k:
                base = code << (k - l)
                self.fast[base : base + (1 << (k - l))] = entry
                self.fast_len[base : base + (1 << (k - l))] = l
            else:
                self.slow[(l, code)] = entry

        # VQ lookup values.
        self.lookup = r.read(4)
        self.vq = None
        if self.lookup in (1, 2):
            minimum = _float32_unpack(r.read(32))
            delta = _float32_unpack(r.read(32))
            value_bits = r.read(4) + 1
            sequence_p = r.read(1)
            if self.lookup == 1:
                v = _lookup1_values(self.entries, self.dims)
                mult = np.array([r.read(value_bits) for _ in range(v)], np.float64)
                idx = np.arange(self.entries)[:, None] // (
                    v ** np.arange(self.dims)[None, :]
                ) % v
                vq = mult[idx] * delta + minimum
            else:
                mult = np.array(
                    [r.read(value_bits) for _ in range(self.entries * self.dims)],
                    np.float64,
                )
                vq = mult.reshape(self.entries, self.dims) * delta + minimum
            if sequence_p:
                vq = np.cumsum(vq, axis=1)
            self.vq = vq
        elif self.lookup != 0:
            raise ValueError(f"{path}: reserved codebook lookup type {self.lookup}")

    def decode_scalar(self, r: BitReader) -> int:
        v, avail = r.peek(_PEEK_BITS)
        idx = int(_rev_table()[v])
        entry = int(self.fast[idx])
        if entry >= 0:
            l = int(self.fast_len[idx])
            if l > avail:
                r.pos = r.nbits
                raise _EndOfPacket
            r.skip(l)
            return entry
        # Long code: bitwise walk beyond the peek window.
        code = idx  # first _PEEK_BITS bits, MSB-first
        if avail < _PEEK_BITS:
            r.pos = r.nbits
            raise _EndOfPacket
        r.skip(_PEEK_BITS)
        length = _PEEK_BITS
        while length < self.max_len:
            code = (code << 1) | r.read(1)
            length += 1
            e = self.slow.get((length, code))
            if e is not None:
                return e
        raise ValueError("invalid Huffman code in stream")

    def decode_vector(self, r: BitReader) -> np.ndarray:
        if self.vq is None:
            raise ValueError("scalar codebook used in VQ context")
        return self.vq[self.decode_scalar(r)]


# ---------------------------------------------------------------------------
# Floor type 1
# ---------------------------------------------------------------------------

# Vorbis I §10.1: floor1_inverse_dB_table (normative constant data).
FLOOR1_INVERSE_DB = np.array([
    1.0649863e-07, 1.1341951e-07, 1.2079015e-07, 1.2863978e-07,
    1.369995e-07, 1.459025e-07, 1.5538409e-07, 1.6548181e-07,
    1.7623574e-07, 1.8768856e-07, 1.9988561e-07, 2.128753e-07,
    2.2670913e-07, 2.4144197e-07, 2.5713223e-07, 2.7384212e-07,
    2.9163793e-07, 3.1059021e-07, 3.3077411e-07, 3.5226968e-07,
    3.7516214e-07, 3.9954229e-07, 4.2550680e-07, 4.5315863e-07,
    4.8260743e-07, 5.1396998e-07, 5.4737065e-07, 5.8294187e-07,
    6.2082472e-07, 6.6116941e-07, 7.0413592e-07, 7.4989464e-07,
    7.9862701e-07, 8.5052630e-07, 9.0579828e-07, 9.6466216e-07,
    1.0273513e-06, 1.0941144e-06, 1.1652161e-06, 1.2409384e-06,
    1.3215816e-06, 1.4074654e-06, 1.4989305e-06, 1.5963394e-06,
    1.7000785e-06, 1.8105592e-06, 1.9282195e-06, 2.0535261e-06,
    2.1869758e-06, 2.3290978e-06, 2.4804557e-06, 2.6416497e-06,
    2.8133190e-06, 2.9961443e-06, 3.1908506e-06, 3.3982101e-06,
    3.6190449e-06, 3.8542308e-06, 4.1047004e-06, 4.3714470e-06,
    4.6555282e-06, 4.9580707e-06, 5.2802740e-06, 5.6234160e-06,
    5.9888572e-06, 6.3780469e-06, 6.7925283e-06, 7.2339451e-06,
    7.7040476e-06, 8.2047000e-06, 8.7378876e-06, 9.3057248e-06,
    9.9104632e-06, 1.0554501e-05, 1.1240392e-05, 1.1970856e-05,
    1.2748789e-05, 1.3577278e-05, 1.4459606e-05, 1.5399272e-05,
    1.6400004e-05, 1.7465768e-05, 1.8600792e-05, 1.9809576e-05,
    2.1096914e-05, 2.2467911e-05, 2.3928002e-05, 2.5482978e-05,
    2.7139006e-05, 2.8902651e-05, 3.0780908e-05, 3.2781225e-05,
    3.4911534e-05, 3.7180282e-05, 3.9596466e-05, 4.2169667e-05,
    4.4910090e-05, 4.7828601e-05, 5.0936773e-05, 5.4246931e-05,
    5.7772202e-05, 6.1526565e-05, 6.5524908e-05, 6.9783085e-05,
    7.4317983e-05, 7.9147585e-05, 8.4291040e-05, 8.9768747e-05,
    9.5602426e-05, 0.00010181521, 0.00010843174, 0.00011547824,
    0.00012298267, 0.00013097477, 0.00013948625, 0.00014855085,
    0.00015820453, 0.00016848555, 0.00017943469, 0.00019109536,
    0.00020351382, 0.00021673929, 0.00023082423, 0.00024582449,
    0.00026179955, 0.00027881276, 0.00029693158, 0.00031622787,
    0.00033677814, 0.00035866388, 0.00038197188, 0.00040679456,
    0.00043323036, 0.00046138411, 0.00049136745, 0.00052329927,
    0.00055730621, 0.00059352311, 0.00063209358, 0.00067317058,
    0.00071691700, 0.00076350630, 0.00081312324, 0.00086596457,
    0.00092223983, 0.00098217216, 0.0010459992, 0.0011139742,
    0.0011863665, 0.0012634633, 0.0013455702, 0.0014330129,
    0.0015261382, 0.0016253153, 0.0017309374, 0.0018434235,
    0.0019632195, 0.0020908006, 0.0022266726, 0.0023713743,
    0.0025254795, 0.0026895994, 0.0028643847, 0.0030505286,
    0.0032487691, 0.0034598925, 0.0036847358, 0.0039241906,
    0.0041792066, 0.0044507950, 0.0047400328, 0.0050480668,
    0.0053761186, 0.0057254891, 0.0060975636, 0.0064938176,
    0.0069158225, 0.0073652516, 0.0078438871, 0.0083536271,
    0.0088964928, 0.009474637, 0.010090352, 0.010746080,
    0.011444421, 0.012188144, 0.012980198, 0.013823725,
    0.014722068, 0.015678791, 0.016697687, 0.017782797,
    0.018938423, 0.020169149, 0.021479854, 0.022875735,
    0.024362330, 0.025945531, 0.027631618, 0.029427276,
    0.031339626, 0.033376252, 0.035545228, 0.037855157,
    0.040315199, 0.042935108, 0.045725273, 0.048696758,
    0.051861348, 0.055231591, 0.058820850, 0.062643361,
    0.066714279, 0.071049749, 0.075666962, 0.080584227,
    0.085821044, 0.091398179, 0.097337747, 0.10366330,
    0.11039993, 0.11757434, 0.12521498, 0.13335215,
    0.14201813, 0.15124727, 0.16107617, 0.17154380,
    0.18269168, 0.19456402, 0.20720788, 0.22067342,
    0.23501402, 0.25028656, 0.26655159, 0.28387361,
    0.30232132, 0.32196786, 0.34289114, 0.36517414,
    0.38890521, 0.41417847, 0.44109412, 0.46975890,
    0.50028648, 0.53279791, 0.56742212, 0.60429640,
    0.64356699, 0.68538959, 0.72993007, 0.77736504,
    0.82788260, 0.88168307, 0.9389798, 1.0,
], dtype=np.float32)


def _low_neighbor(x, i):
    best, bx = None, None
    for j in range(i):
        if x[j] < x[i] and (bx is None or x[j] > bx):
            best, bx = j, x[j]
    return best


def _high_neighbor(x, i):
    best, bx = None, None
    for j in range(i):
        if x[j] > x[i] and (bx is None or x[j] < bx):
            best, bx = j, x[j]
    return best


def _render_point(x0, y0, x1, y1, x):
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    off = (ady * (x - x0)) // adx
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0, y0, x1, y1, v, n):
    dy = y1 - y0
    adx = x1 - x0
    base = int(dy / adx)  # truncation toward zero (spec)
    sy = base - 1 if dy < 0 else base + 1
    ady = abs(dy) - abs(base) * adx
    x_end = min(x1, n)
    if x0 >= n:
        return
    v[x0] = y0
    err = 0
    y = y0
    for x in range(x0 + 1, x_end):
        err += ady
        if err >= adx:
            err -= adx
            y += sy
        else:
            y += base
        v[x] = y


class Floor1:
    def __init__(self, r: BitReader, path):
        self.partitions = r.read(5)
        self.class_list = [r.read(4) for _ in range(self.partitions)]
        max_class = max(self.class_list) if self.class_list else -1
        self.class_dims = []
        self.class_subs = []
        self.class_master = []
        self.sub_books = []
        for _ in range(max_class + 1):
            self.class_dims.append(r.read(3) + 1)
            subs = r.read(2)
            self.class_subs.append(subs)
            self.class_master.append(r.read(8) if subs else 0)
            self.sub_books.append([r.read(8) - 1 for _ in range(1 << subs)])
        self.multiplier = r.read(2) + 1
        rangebits = r.read(4)
        xs = [0, 1 << rangebits]
        for p in range(self.partitions):
            cls = self.class_list[p]
            for _ in range(self.class_dims[cls]):
                xs.append(r.read(rangebits))
        if len(set(xs)) != len(xs):
            raise ValueError(f"{path}: floor1 X values not unique (undecodable)")
        self.x = xs
        self.sort_idx = sorted(range(len(xs)), key=lambda i: xs[i])
        # neighbor/prediction structure is static per floor config
        self.lo = [0, 0] + [_low_neighbor(xs, i) for i in range(2, len(xs))]
        self.hi = [0, 0] + [_high_neighbor(xs, i) for i in range(2, len(xs))]
        self.range = [256, 128, 86, 64][self.multiplier - 1]

    def decode(self, r: BitReader, books: list[Codebook]):
        """Decoded post vector (final_Y, step2 flags) or None (unused)."""
        if not r.read(1):
            return None
        rng = self.range
        bits = _ilog(rng - 1)
        y = [r.read(bits), r.read(bits)]
        for p in range(self.partitions):
            cls = self.class_list[p]
            cdim = self.class_dims[cls]
            cbits = self.class_subs[cls]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                cval = books[self.class_master[cls]].decode_scalar(r)
            for _ in range(cdim):
                book = self.sub_books[cls][cval & csub]
                cval >>= cbits
                y.append(books[book].decode_scalar(r) if book >= 0 else 0)

        # Amplitude synthesis (§7.2.4).
        n_posts = len(self.x)
        final = [0] * n_posts
        flags = [False] * n_posts
        final[0], final[1] = y[0], y[1]
        flags[0] = flags[1] = True
        for i in range(2, n_posts):
            lo, hi = self.lo[i], self.hi[i]
            predicted = _render_point(
                self.x[lo], final[lo], self.x[hi], final[hi], self.x[i]
            )
            val = y[i]
            highroom = rng - predicted
            lowroom = predicted
            room = 2 * min(highroom, lowroom)
            if val:
                flags[lo] = flags[hi] = flags[i] = True
                if val >= room:
                    final[i] = (
                        val - lowroom + predicted
                        if highroom > lowroom
                        else predicted - (val - highroom) - 1
                    )
                else:
                    final[i] = (
                        predicted - ((val + 1) // 2)
                        if val & 1
                        else predicted + val // 2
                    )
            else:
                flags[i] = False
                final[i] = predicted
        return final, flags

    def curve(self, posts, n: int) -> np.ndarray:
        """Rendered floor curve (length n, linear amplitude)."""
        final, flags = posts
        mult = self.multiplier
        rng = self.range
        v = np.zeros(n, np.int64)
        hx = 0
        lx = 0
        ly = min(max(final[0], 0), rng - 1) * mult
        hy = ly
        for i in self.sort_idx[1:]:
            if not flags[i]:
                continue
            hx = self.x[i]
            hy = min(max(final[i], 0), rng - 1) * mult
            if hx >= n and lx >= n:
                break
            _render_line(lx, ly, hx, hy, v, n)
            lx, ly = hx, hy
        if hx < n:
            v[hx:] = hy  # horizontal continuation of the last post
        np.clip(v, 0, 255, out=v)
        return FLOOR1_INVERSE_DB[v].astype(np.float64)


# ---------------------------------------------------------------------------
# Residues
# ---------------------------------------------------------------------------


class Residue:
    def __init__(self, rtype: int, r: BitReader, path):
        self.type = rtype
        self.begin = r.read(24)
        self.end = r.read(24)
        self.psize = r.read(24) + 1
        self.classifications = r.read(6) + 1
        self.classbook = r.read(8)
        cascade = []
        for _ in range(self.classifications):
            low = r.read(3)
            high = r.read(5) if r.read(1) else 0
            cascade.append((high << 3) | low)
        self.books = []
        for c in range(self.classifications):
            row = []
            for p in range(8):
                row.append(r.read(8) if (cascade[c] & (1 << p)) else -1)
            self.books.append(row)

    def decode(self, r: BitReader, books, do_not_decode, n: int):
        """Decode into (len(do_not_decode), n) float64; types 0/1 per-channel,
        type 2 interleaved across channels."""
        ch = len(do_not_decode)
        out = np.zeros((ch, n), np.float64)
        if self.type == 2:
            if all(do_not_decode):
                return out
            v = np.zeros(n * ch, np.float64)
            self._decode_vectors(r, books, [v], [False], n * ch)
            for j in range(ch):
                out[j] = v[j::ch]
            return out
        self._decode_vectors(r, books, list(out), do_not_decode, n)
        return out

    def _decode_vectors(self, r, books, vectors, dnd, actual_size):
        begin = min(self.begin, actual_size)
        end = min(self.end, actual_size)
        n_to_read = end - begin
        if n_to_read <= 0:
            return
        psize = self.psize
        parts = n_to_read // psize
        classbook = books[self.classbook]
        classwords = classbook.dims
        fmt = 0 if self.type == 0 else 1
        ch = len(vectors)
        classif = [[0] * (parts + classwords) for _ in range(ch)]
        try:
            for p in range(8):
                pc = 0
                while pc < parts:
                    if p == 0:
                        for j in range(ch):
                            if dnd[j]:
                                continue
                            temp = classbook.decode_scalar(r)
                            for i in range(classwords - 1, -1, -1):
                                classif[j][pc + i] = temp % self.classifications
                                temp //= self.classifications
                    i = 0
                    while i < classwords and pc < parts:
                        for j in range(ch):
                            if dnd[j]:
                                continue
                            book_i = self.books[classif[j][pc]][p]
                            if book_i < 0:
                                continue
                            book = books[book_i]
                            offset = begin + pc * psize
                            v = vectors[j]
                            dim = book.dims
                            if fmt == 0:
                                step = psize // dim
                                for s in range(step):
                                    vec = book.decode_vector(r)
                                    v[offset + s : offset + s + dim * step : step] += vec
                            else:
                                k = 0
                                while k < psize:
                                    vec = book.decode_vector(r)
                                    v[offset + k : offset + k + dim] += vec
                                    k += dim
                        i += 1
                        pc += 1
        except _EndOfPacket:
            return  # partial decode is not an error (Vorbis I §1.1.4)


# ---------------------------------------------------------------------------
# Mappings / modes / setup
# ---------------------------------------------------------------------------


class Mapping:
    def __init__(self, r: BitReader, channels: int, path):
        if r.read(16) != 0:
            raise ValueError(f"{path}: nonzero mapping type is reserved")
        self.submaps = r.read(4) + 1 if r.read(1) else 1
        self.coupling = []
        if r.read(1):
            steps = r.read(8) + 1
            bits = _ilog(channels - 1)
            for _ in range(steps):
                mag = r.read(bits)
                ang = r.read(bits)
                if mag == ang or mag >= channels or ang >= channels:
                    raise ValueError(f"{path}: invalid coupling step")
                self.coupling.append((mag, ang))
        if r.read(2) != 0:
            raise ValueError(f"{path}: nonzero mapping reserved bits")
        if self.submaps > 1:
            self.mux = [r.read(4) for _ in range(channels)]
            if any(m >= self.submaps for m in self.mux):
                raise ValueError(f"{path}: channel mux exceeds submap count")
        else:
            self.mux = [0] * channels
        self.submap_floor = []
        self.submap_residue = []
        for _ in range(self.submaps):
            r.read(8)  # unused time configuration
            self.submap_floor.append(r.read(8))
            self.submap_residue.append(r.read(8))


class Mode:
    def __init__(self, r: BitReader, path):
        self.blockflag = r.read(1)
        if r.read(16) != 0 or r.read(16) != 0:
            raise ValueError(f"{path}: nonzero window/transform type is reserved")
        self.mapping = r.read(8)


class Setup:
    def __init__(self, ident: bytes, setup: bytes, path):
        r = BitReader(ident)
        if r.read(8) != 1 or bytes(r.read(8) for _ in range(6)) != b"vorbis":
            raise ValueError(f"{path}: bad identification header")
        if r.read(32) != 0:
            raise ValueError(f"{path}: unsupported Vorbis version")
        self.channels = r.read(8)
        self.rate = r.read(32)
        r.read(32), r.read(32), r.read(32)  # bitrate bounds
        self.bs0 = 1 << r.read(4)
        self.bs1 = 1 << r.read(4)
        if not (64 <= self.bs0 <= self.bs1 <= 8192) or not r.read(1):
            raise ValueError(f"{path}: invalid blocksizes or framing bit")
        if self.channels == 0 or self.rate == 0:
            raise ValueError(f"{path}: bad vorbis stream info")

        r = BitReader(setup)
        if r.read(8) != 5 or bytes(r.read(8) for _ in range(6)) != b"vorbis":
            raise ValueError(f"{path}: bad setup header")
        self.books = [Codebook(r, path) for _ in range(r.read(8) + 1)]
        for _ in range(r.read(6) + 1):  # time domain transforms (placeholders)
            if r.read(16) != 0:
                raise ValueError(f"{path}: nonzero time transform is reserved")
        self.floors = []
        for _ in range(r.read(6) + 1):
            ftype = r.read(16)
            if ftype == 1:
                self.floors.append(Floor1(r, path))
            elif ftype == 0:
                raise ValueError(
                    f"{path}: floor type 0 (LSP) is not implemented — no modern "
                    "encoder emits it and no conformance vector is producible "
                    "here; decode with libvorbisfile instead"
                )
            else:
                raise ValueError(f"{path}: reserved floor type {ftype}")
        self.residues = []
        for _ in range(r.read(6) + 1):
            rtype = r.read(16)
            if rtype > 2:
                raise ValueError(f"{path}: reserved residue type {rtype}")
            self.residues.append(Residue(rtype, r, path))
        self.mappings = [Mapping(r, self.channels, path) for _ in range(r.read(6) + 1)]
        self.modes = [Mode(r, path) for _ in range(r.read(6) + 1)]
        if not r.read(1):
            raise ValueError(f"{path}: setup framing bit unset")

        # Cross-reference validation so corrupt setups raise ValueError here
        # rather than IndexError deep in packet decode.
        nb = len(self.books)
        for fl in self.floors:
            if any(m >= nb for m in fl.class_master) or any(
                b >= nb for row in fl.sub_books for b in row
            ):
                raise ValueError(f"{path}: floor references nonexistent codebook")
        for res in self.residues:
            if res.classbook >= nb or any(
                b >= nb for row in res.books for b in row
            ):
                raise ValueError(f"{path}: residue references nonexistent codebook")
        for mp in self.mappings:
            if any(f >= len(self.floors) for f in mp.submap_floor) or any(
                rr >= len(self.residues) for rr in mp.submap_residue
            ):
                raise ValueError(f"{path}: mapping references nonexistent floor/residue")
        for md in self.modes:
            if md.mapping >= len(self.mappings):
                raise ValueError(f"{path}: mode references nonexistent mapping")


# ---------------------------------------------------------------------------
# Transform + window
# ---------------------------------------------------------------------------

_IMDCT_CACHE: dict[int, np.ndarray] = {}
_SLOPE_CACHE: dict[int, np.ndarray] = {}


def _imdct_basis(n: int) -> np.ndarray:
    b = _IMDCT_CACHE.get(n)
    if b is None:
        k = np.arange(n // 2, dtype=np.float64)
        t = np.arange(n, dtype=np.float64)
        b = np.cos(
            (2.0 * np.pi / n) * (t[:, None] + 0.5 + n / 4.0) * (k[None, :] + 0.5)
        )
        _IMDCT_CACHE[n] = b
    return b


def _slope(m: int) -> np.ndarray:
    """Rising half-window of total size 2m: sin(pi/2 sin^2(pi(i+.5)/2m))."""
    s = _SLOPE_CACHE.get(m)
    if s is None:
        i = np.arange(m, dtype=np.float64)
        s = np.sin(0.5 * np.pi * np.sin(np.pi * (i + 0.5) / (2 * m)) ** 2)
        _SLOPE_CACHE[m] = s
    return s


def _window(n: int, left_n: int, right_n: int) -> np.ndarray:
    """Lapped window: rising slope of size left_n centered at n/4, unity
    middle, falling slope of size right_n centered at 3n/4, zero outside."""
    w = np.zeros(n, np.float64)
    ls = n // 4 - left_n // 2
    w[ls : ls + left_n] = _slope(left_n)
    rs = 3 * n // 4 - right_n // 2
    w[ls + left_n : rs] = 1.0
    w[rs : rs + right_n] = _slope(right_n)[::-1]
    return w


# ---------------------------------------------------------------------------
# Stream decode
# ---------------------------------------------------------------------------


def _decode_audio_packet(setup: Setup, packet: bytes, prev: dict):
    """One audio packet -> (pcm_chunk (ch, m) or None, updated prev state)."""
    r = BitReader(packet)
    try:
        if r.read(1) != 0:
            return None  # not an audio packet: skip (spec)
        mode = setup.modes[r.read(_ilog(len(setup.modes) - 1))]
    except _EndOfPacket:
        return None
    mapping = setup.mappings[mode.mapping]
    ch = setup.channels
    n = setup.bs1 if mode.blockflag else setup.bs0
    half = n // 2
    if mode.blockflag:
        try:
            prev_flag = r.read(1)
            next_flag = r.read(1)
        except _EndOfPacket:
            return None
    else:
        prev_flag = next_flag = 1

    posts = [None] * ch
    residue_out = np.zeros((ch, half), np.float64)
    try:
        for i in range(ch):
            floor = setup.floors[mapping.submap_floor[mapping.mux[i]]]
            posts[i] = floor.decode(r, setup.books)
        decode_flag = [p is not None for p in posts]
        for mag, ang in mapping.coupling:
            if decode_flag[mag] or decode_flag[ang]:
                decode_flag[mag] = decode_flag[ang] = True
        for s in range(mapping.submaps):
            chans = [i for i in range(ch) if mapping.mux[i] == s]
            dnd = [not decode_flag[i] for i in chans]
            res = setup.residues[mapping.submap_residue[s]]
            dec = res.decode(r, setup.books, dnd, half)
            for k, i in enumerate(chans):
                residue_out[i] = dec[k]
    except _EndOfPacket:
        pass  # partial packets are used as-is (Vorbis I §1.1.4)

    # Inverse channel coupling (§4.3.5), in reverse step order.
    for mag, ang in reversed(mapping.coupling):
        m = residue_out[mag].copy()
        a = residue_out[ang].copy()
        pos_m = m > 0
        pos_a = a > 0
        new_m = np.where(pos_m, np.where(pos_a, m, m + a), np.where(pos_a, m, m - a))
        new_a = np.where(pos_m, np.where(pos_a, m - a, m), np.where(pos_a, m + a, m))
        residue_out[mag] = new_m
        residue_out[ang] = new_a

    # Floor curve multiply + IMDCT + window.
    basis = _imdct_basis(n)
    left_n = setup.bs0 // 2 if (mode.blockflag and not prev_flag) else half
    right_n = setup.bs0 // 2 if (mode.blockflag and not next_flag) else half
    w = _window(n, left_n, right_n)
    blocks = np.zeros((ch, n), np.float64)
    for i in range(ch):
        if posts[i] is None:
            continue
        floor = setup.floors[mapping.submap_floor[mapping.mux[i]]]
        spectrum = floor.curve(posts[i], half) * residue_out[i]
        blocks[i] = (basis @ spectrum) * w

    # Overlap-add against the previous block.
    p = prev.get("block")
    chunk = None
    if p is not None:
        pn = p.shape[1]
        m = pn // 4 + n // 4
        chunk = np.zeros((ch, m), np.float64)
        l1 = min(m, pn // 2)
        chunk[:, :l1] += p[:, pn // 2 : pn // 2 + l1]
        j0 = max(0, pn // 4 - n // 4)
        chunk[:, j0:] += blocks[:, j0 + n // 4 - pn // 4 : half]
    prev["block"] = blocks
    return chunk


def decode_ogg_vorbis(data: bytes, path="<bytes>") -> tuple[np.ndarray, int]:
    """Decode a whole Ogg/Vorbis byte stream -> (float32 (ch, T), rate).

    Supports grouped (multiplexed) streams by selecting the first Vorbis
    logical stream, and chained streams when every link shares the channel
    count and rate (ValueError otherwise — the same loud-failure semantics
    as the libvorbisfile binding in data/ogg.py).
    """
    all_pages = list(_parse_pages(data, path))
    if not all_pages:
        raise ValueError(f"{path}: no Ogg pages found")

    # Split into chain links: a link is delimited by BOS pages per serial.
    # Grouped streams interleave serials; pick the serial whose BOS packet
    # is a Vorbis identification header.
    out_chunks: list[np.ndarray] = []
    rate = channels = None
    i = 0
    while i < len(all_pages):
        # find the vorbis BOS at/after i
        serial = None
        while i < len(all_pages):
            pg = all_pages[i]
            if pg.flags & 0x02 and pg.segments:
                first = pg.segments[0][0]
                if first[:7] == b"\x01vorbis":
                    serial = pg.serial
                    break
            i += 1
        if serial is None:
            break
        link_pages = []
        j = i
        ended = False
        while j < len(all_pages):
            pg = all_pages[j]
            if pg.serial == serial:
                link_pages.append(pg)
                if pg.flags & 0x04:  # EOS
                    ended = True
                    j += 1
                    break
            j += 1
        i = j if ended else len(all_pages)

        pcm, r_, ch_ = _decode_link(link_pages, path)
        if rate is None:
            rate, channels = r_, ch_
        elif (r_, ch_) != (rate, channels):
            raise ValueError(
                f"{path}: chained Ogg stream changes format mid-file "
                f"({channels}ch@{rate} -> {ch_}ch@{r_}); unsupported"
            )
        out_chunks.append(pcm)

    if not out_chunks:
        raise ValueError(f"{path}: no decodable vorbis frames")
    return np.concatenate(out_chunks, axis=1), rate


def _decode_link(pages, path) -> tuple[np.ndarray, int, int]:
    packets, page_marks = _assemble_packets(pages, path)
    if len(packets) < 3:
        raise ValueError(f"{path}: missing Vorbis headers")
    if packets[1][:7] != b"\x03vorbis" or packets[2][:7] != b"\x05vorbis":
        raise ValueError(f"{path}: malformed Vorbis header sequence")
    setup = Setup(packets[0], packets[2], path)

    prev: dict = {}
    chunks: list[np.ndarray] = []
    # cum_len[k] = samples produced by audio packets 3..3+k (for granule math)
    cum_len = [0]
    for pk in packets[3:]:
        chunk = _decode_audio_packet(setup, pk, prev)
        if chunk is not None and chunk.shape[1]:
            chunks.append(chunk)
            cum_len.append(cum_len[-1] + chunk.shape[1])
        else:
            cum_len.append(cum_len[-1])

    if not chunks:
        raise ValueError(f"{path}: no decodable vorbis frames")
    pcm = np.concatenate(chunks, axis=1)

    # Granule trimming: the last page's granulepos is the total decodable
    # sample count of the link; a SHORT first audio page granule trims the
    # beginning (sample-accurate stream starts).
    granules = [(cnt, g) for cnt, g in page_marks if g >= 0 and cnt > 3]
    if granules:
        start_trim = 0
        if len(granules) > 1:
            # A SHORT granule on a non-final audio page marks a sample-accurate
            # stream start: prune the beginning.  (On the final page the short
            # granule prunes the END instead — lapped-tail padding.)
            first_cnt, first_g = granules[0]
            start_trim = max(0, cum_len[first_cnt - 3] - first_g)
        last_g = granules[-1][1]
        end = min(pcm.shape[1], start_trim + last_g)
        pcm = pcm[:, start_trim:end]
    return pcm.astype(np.float32), setup.rate, setup.channels


def read_ogg_pure(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode an Ogg/Vorbis FILE with the self-contained decoder."""
    data = Path(path).read_bytes()
    return decode_ogg_vorbis(data, path)
