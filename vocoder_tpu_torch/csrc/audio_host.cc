// Host-side audio work for the PyTorch port's input pipeline: FLAC
// (RFC 9639) and Ogg/Vorbis (libvorbisfile, dlopen'd at first use) decoding,
// each as one call per file that holds no Python lock, and the polyphase
// resampler of 1-D audio.  A copy of those parts of the JAX package's
// native/audio_kernels.cc, kept apart so that the port builds and binds its
// own library; the numpy paths in vocoder_tpu_torch/data remain the fallback
// without a compiler and the reference the tests hold this to.
//
// Built at first use by vocoder_tpu_torch/data/native.py (the system C++
// compiler, -O3 -fPIC -march=native -std=c++17 -shared -ldl) into build/kernels/.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Polyphase sinc resampler (same math as vocoder_tpu_torch/data/resample.py,
// i.e. torchaudio.functional.resample semantics: sinc_interp_hann, width 6,
// rolloff 0.99).  The kernel table is computed by the Python side and passed
// in, so both paths share one filter design.  Unlike the JAX package's copy,
// each phase sums only its run of nonzero taps (the window ends at
// +-lowpass_filter_width, past which the table holds exact zeros: 441 -> 160
// keeps ~34 of 475 taps) in 8 partial sums that the compiler vectorises, so
// the rounding differs from a serial sum (within the parity test's rtol 1e-4).
// ---------------------------------------------------------------------------

// x: (T,), kernels: (new_freq, taps), y: (ceil(new_freq*T/orig_freq),)
void resample_poly(const float* x, int64_t t, const float* kernels, int new_freq,
                   int orig_freq, int taps, int width, float* y, int64_t y_len) {
  constexpr int kLanes = 8;
  std::vector<int64_t> first(new_freq), last(new_freq);  // each phase's nonzero taps [first, last)
  for (int j = 0; j < new_freq; ++j) {
    const float* k = kernels + (int64_t)j * taps;
    int64_t a = 0, b = taps;
    while (a < b && k[a] == 0.0f) ++a;
    while (b > a && k[b - 1] == 0.0f) --b;
    first[j] = a;
    last[j] = b;
  }
  // Virtual left pad of `width` zeros; right pad width + orig_freq.
  int64_t n_frames = (t + width + width + orig_freq - taps) / orig_freq + 1;
  int64_t out_idx = 0;
  for (int64_t f = 0; f < n_frames && out_idx < y_len; ++f) {
    int64_t base = f * orig_freq - width;  // position of tap 0 in x
    const float* xb = x + base;
    for (int j = 0; j < new_freq && out_idx < y_len; ++j) {
      const float* k = kernels + (int64_t)j * taps;
      int64_t lo = first[j], hi = last[j];
      if (base + lo < 0) lo = -base;
      if (base + hi > t) hi = t - base;
      float part[kLanes] = {0.0f};
      int64_t i = lo;
      for (; i + kLanes <= hi; i += kLanes)
        for (int l = 0; l < kLanes; ++l) part[l] += xb[i + l] * k[i + l];
      if (i + 4 <= hi) {
        for (int l = 0; l < 4; ++l) part[l] += xb[i + l] * k[i + l];
        i += 4;
      }
      float acc = 0.0f;
      for (; i < hi; ++i) acc += xb[i] * k[i];
      for (int l = 0; l < kLanes; ++l) acc += part[l];
      y[out_idx++] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// FLAC decoder (subset: the format produced by real encoders — CONSTANT /
// VERBATIM / FIXED / LPC subframes, rice residuals, all four stereo
// decorrelation modes).  The reference decodes FLAC through torchaudio's
// libsox backend; here the train-path decode must keep up with the train
// step, which the pure-Python decoder (vocoder_tpu_torch/data/flac.py — kept
// as the behaviour oracle + fallback) cannot.  Layout and error semantics mirror the Python decoder exactly so
// both are covered by one parity test.
// ---------------------------------------------------------------------------

namespace flac {

struct BitReader {
  const uint8_t* d;
  int64_t n;      // total bytes
  int64_t pos;    // bit position
  bool fail = false;

  uint64_t read(int bits) {
    uint64_t v = 0;
    for (int i = 0; i < bits; ++i) {
      int64_t byte = (pos + i) >> 3;
      if (byte >= n) { fail = true; return 0; }
      v = (v << 1) | ((d[byte] >> (7 - ((pos + i) & 7))) & 1);
    }
    pos += bits;
    return v;
  }

  int64_t read_signed(int bits) {
    if (bits == 0) return 0;
    uint64_t v = read(bits);
    if (v & (1ull << (bits - 1))) return (int64_t)(v - (1ull << bits));
    return (int64_t)v;
  }

  int64_t read_unary() {
    int64_t q = 0;
    while (true) {
      int64_t byte = pos >> 3;
      if (byte >= n) { fail = true; return 0; }
      if ((d[byte] >> (7 - (pos & 7))) & 1) { ++pos; return q; }
      ++pos;
      ++q;
    }
  }

  uint64_t read_utf8() {
    uint64_t b0 = read(8);
    int extra = 0;
    uint64_t v = b0;
    if (b0 < 0x80) return b0;
    for (uint64_t mask = 0x40; b0 & mask; mask >>= 1) { ++extra; }
    if (extra > 6) { fail = true; return 0; }  // lead byte 0xFE/0xFF: invalid
    v = b0 & ((1ull << (6 - extra)) - 1);
    for (int i = 0; i < extra; ++i) v = (v << 6) | (read(8) & 0x3F);
    return v;
  }

  void align() { pos = (pos + 7) & ~7ll; }
};

static const int kBlockSizes[16] = {0, 192, 576, 1152, 2304, 4608, -1, -1,
                                    256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
static const int kSampleSizes[8] = {0, 8, 12, 0, 16, 20, 24, 32};

static uint8_t crc8_table[256];
static bool crc8_init_done = false;
static void crc8_init() {
  if (crc8_init_done) return;
  for (int i = 0; i < 256; ++i) {
    uint8_t c = (uint8_t)i;
    for (int j = 0; j < 8; ++j) c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
    crc8_table[i] = c;
  }
  crc8_init_done = true;
}
static uint8_t crc8(const uint8_t* p, int64_t n) {
  crc8_init();
  uint8_t c = 0;
  for (int64_t i = 0; i < n; ++i) c = crc8_table[c ^ p[i]];
  return c;
}

// Decode one residual partition set into out[block_size - order].
static bool decode_residual(BitReader& br, int block_size, int order, int64_t* out) {
  int method = (int)br.read(2);
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  int escape = (1 << param_bits) - 1;
  int po = (int)br.read(4);
  int64_t fill = 0;
  for (int part = 0; part < (1 << po); ++part) {
    int64_t count;
    if (po == 0) count = block_size - order;
    else if (part == 0) count = (block_size >> po) - order;
    else count = block_size >> po;
    int param = (int)br.read(param_bits);
    if (param == escape) {
      int raw = (int)br.read(5);
      for (int64_t i = 0; i < count; ++i) out[fill + i] = raw ? br.read_signed(raw) : 0;
    } else {
      for (int64_t i = 0; i < count; ++i) {
        int64_t q = br.read_unary();
        uint64_t r = br.read(param);
        uint64_t u = ((uint64_t)q << param) | r;
        out[fill + i] = (u & 1) ? -((int64_t)(u >> 1)) - 1 : (int64_t)(u >> 1);
      }
    }
    fill += count;
    if (br.fail) return false;
  }
  return fill == block_size - order;
}

static bool decode_subframe(BitReader& br, int block_size, int bps, int64_t* out,
                            std::vector<int64_t>& scratch) {
  if (br.read(1) != 0) return false;
  int sf_type = (int)br.read(6);
  int wasted = 0;
  if (br.read(1)) wasted = (int)br.read_unary() + 1;
  // A hostile unary run can make `wasted` arbitrarily large; shifting by
  // >= 64 (or leaving bps <= 0) is UB.  The Python oracle errors out here.
  if (wasted >= bps) return false;
  bps -= wasted;

  if (sf_type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (sf_type == 1) {  // VERBATIM
    for (int i = 0; i < block_size; ++i) out[i] = br.read_signed(bps);
  } else if (sf_type >= 8 && sf_type <= 12) {  // FIXED order 0-4
    int order = sf_type - 8;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    scratch.resize(block_size);
    if (!decode_residual(br, block_size, order, scratch.data())) return false;
    static const int coef[5][4] = {{}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};
    for (int i = order; i < block_size; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += (int64_t)coef[order][j] * out[i - 1 - j];
      out[i] = scratch[i - order] + acc;
    }
  } else if (sf_type >= 32) {  // LPC order 1-32
    int order = sf_type - 31;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    int precision = (int)br.read(4) + 1;
    if (precision == 16) return false;
    int shift = (int)br.read_signed(5);
    // Negative shift is "reserved" in RFC 9639 §9.2.6; `acc >> negative` is UB
    // in C++.  The Python oracle raises on it — match that error path.
    if (shift < 0) return false;
    int64_t coefs[32];
    for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
    scratch.resize(block_size);
    if (!decode_residual(br, block_size, order, scratch.data())) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coefs[j] * out[i - 1 - j];
      out[i] = scratch[i - order] + (acc >> shift);
    }
  } else {
    return false;
  }
  if (br.fail) return false;
  if (wasted) for (int i = 0; i < block_size; ++i) out[i] <<= wasted;
  return true;
}

}  // namespace flac

// Parse STREAMINFO.  info[0..3] = {sample_rate, channels, bps, total_samples};
// info[4] = bit offset of the first frame.  Returns 0 on success, <0 on error.
int flac_probe(const uint8_t* data, int64_t n, int64_t* info) {
  if (n < 8 || memcmp(data, "fLaC", 4) != 0) return -1;
  int64_t pos = 4;
  bool have = false;
  while (pos + 4 <= n) {
    int last = data[pos] >> 7, btype = data[pos] & 0x7F;
    int64_t length = ((int64_t)data[pos + 1] << 16) | ((int64_t)data[pos + 2] << 8) | data[pos + 3];
    if (btype == 0 && pos + 4 + length <= n) {
      flac::BitReader si{data, n, (pos + 4) * 8};
      si.read(16); si.read(16); si.read(24); si.read(24);
      info[0] = (int64_t)si.read(20);
      info[1] = (int64_t)si.read(3) + 1;
      info[2] = (int64_t)si.read(5) + 1;
      info[3] = (int64_t)si.read(36);
      have = true;
    }
    pos += 4 + length;
    if (last) break;
  }
  if (!have || pos > n) return -2;
  info[4] = pos * 8;
  return 0;
}

// Decode into out (channels, total) planar float32.  Returns the number of
// decoded frames (== total on success), or <0 on error.
int64_t flac_decode(const uint8_t* data, int64_t n, int64_t start_bits, int channels,
                    int bps, int64_t total, float* out) {
  flac::BitReader br{data, n, start_bits};
  std::vector<std::vector<int64_t>> subs((size_t)channels + 1);
  std::vector<int64_t> scratch;
  int64_t done = 0;
  const float scale = 1.0f / (float)(1ll << (bps - 1));
  while (br.pos + 32 <= n * 8 && done < total) {
    if (br.read(14) != 0b11111111111110) return -3;
    int64_t header_start_byte = (br.pos - 14) >> 3;
    br.read(1); br.read(1);
    int bs_code = (int)br.read(4);
    int sr_code = (int)br.read(4);
    int ch_code = (int)br.read(4);
    int ss_code = (int)br.read(3);
    br.read(1);
    br.read_utf8();
    int block_size;
    if (bs_code == 6) block_size = (int)br.read(8) + 1;
    else if (bs_code == 7) block_size = (int)br.read(16) + 1;
    else { block_size = flac::kBlockSizes[bs_code]; if (block_size <= 0) return -4; }
    if (sr_code == 12) br.read(8);
    else if (sr_code == 13 || sr_code == 14) br.read(16);
    int frame_bps = ss_code == 0 ? bps : flac::kSampleSizes[ss_code];
    if (frame_bps == 0) return -5;
    int64_t header_end_byte = br.pos >> 3;
    uint8_t want = flac::crc8(data + header_start_byte, header_end_byte - header_start_byte);
    if (br.fail || (uint8_t)br.read(8) != want) return -6;

    if (ch_code > 10) return -10;  // reserved channel assignment (Python parity)
    int n_sub = ch_code < 8 ? ch_code + 1 : 2;
    if (ch_code < 8 && n_sub != channels) return -7;
    for (int c = 0; c < n_sub; ++c) {
      subs[(size_t)c].resize((size_t)block_size);
      int sub_bps = frame_bps;
      if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) || (ch_code == 10 && c == 1))
        sub_bps += 1;
      if (!flac::decode_subframe(br, block_size, sub_bps, subs[(size_t)c].data(), scratch))
        return -8;
    }
    br.align();
    br.read(16);  // frame CRC-16 (header CRC already validated)
    if (br.fail) return -9;

    int64_t take = block_size;
    if (done + take > total) take = total - done;
    if (ch_code < 8) {
      for (int c = 0; c < channels; ++c) {
        float* dst = out + (int64_t)c * total + done;
        const int64_t* s = subs[(size_t)c].data();
        for (int64_t i = 0; i < take; ++i) dst[i] = (float)s[i] * scale;
      }
    } else {
      if (channels != 2) return -7;
      float* l = out + done;
      float* r = out + total + done;
      const int64_t* a = subs[0].data();
      const int64_t* b = subs[1].data();
      for (int64_t i = 0; i < take; ++i) {
        int64_t lv, rv;
        if (ch_code == 8) { lv = a[i]; rv = a[i] - b[i]; }
        else if (ch_code == 9) { lv = b[i] + a[i]; rv = b[i]; }
        else { int64_t m2 = (a[i] << 1) | (b[i] & 1); lv = (m2 + b[i]) >> 1; rv = (m2 - b[i]) >> 1; }
        l[i] = (float)lv * scale;
        r[i] = (float)rv * scale;
      }
    }
    done += take;
  }
  return done;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Ogg/Vorbis decode via libvorbisfile (dlopen'd at first use, so the library
// stays dependency-free to BUILD; decode availability mirrors the ctypes
// binding in vocoder_tpu_torch/data/ogg.py).  The whole pull loop runs here in one
// foreign call — the Python chunk loop holds the GIL between ~170 tiny
// ov_read_float calls per clip, which serialises the thread-pool workers.
// ---------------------------------------------------------------------------

#include <dlfcn.h>

namespace {

// First three fields of vorbis_info (stable public ABI).
struct VorbisInfoABI {
  int version;
  int channels;
  long rate;
};

struct VorbisFns {
  int (*ov_fopen)(const char*, void*);
  VorbisInfoABI* (*ov_info)(void*, int);
  long (*ov_read_float)(void*, float***, int, int*);
  int64_t (*ov_pcm_total)(void*, int);
  long (*ov_streams)(void*);
  int (*ov_clear)(void*);
};

const VorbisFns* vorbis_fns() {
  static VorbisFns fns;
  static bool ok = []() {
    void* h = dlopen("libvorbisfile.so.3", RTLD_NOW | RTLD_LOCAL);
    if (!h) h = dlopen("libvorbisfile.so", RTLD_NOW | RTLD_LOCAL);
    if (!h) return false;
    fns.ov_fopen = (int (*)(const char*, void*))dlsym(h, "ov_fopen");
    fns.ov_info = (VorbisInfoABI * (*)(void*, int)) dlsym(h, "ov_info");
    fns.ov_read_float = (long (*)(void*, float***, int, int*))dlsym(h, "ov_read_float");
    fns.ov_pcm_total = (int64_t(*)(void*, int))dlsym(h, "ov_pcm_total");
    fns.ov_streams = (long (*)(void*))dlsym(h, "ov_streams");
    fns.ov_clear = (int (*)(void*))dlsym(h, "ov_clear");
    return fns.ov_fopen && fns.ov_info && fns.ov_read_float && fns.ov_pcm_total &&
           fns.ov_streams && fns.ov_clear;
  }();
  return ok ? &fns : nullptr;
}

// OggVorbis_File is ~720 bytes on every known ABI; over-allocate generously.
constexpr int kOvfBytes = 4096;

}  // namespace

extern "C" {

// info[0..2] = {channels, rate, total_frames}.  Returns 0 on success,
// -1 when libvorbisfile is unavailable or the file is not decodable,
// -2 when the total length is unknown (caller falls back to the pull loop).
int ogg_probe(const char* path, int64_t* info) {
  const VorbisFns* v = vorbis_fns();
  if (!v) return -1;
  alignas(16) char ovf[kOvfBytes];
  if (v->ov_fopen(path, ovf) != 0) return -1;
  VorbisInfoABI* vi = v->ov_info(ovf, -1);
  if (!vi || vi->channels <= 0 || vi->rate <= 0) {
    v->ov_clear(ovf);
    return -1;
  }
  // Chained (multi-link) files: ov_pcm_total(-1) under-reports here and a
  // later link may change format; hand those to the ctypes pull loop, which
  // decodes across links and raises on format changes.
  if (v->ov_streams(ovf) != 1) {
    v->ov_clear(ovf);
    return -2;
  }
  int64_t total = v->ov_pcm_total(ovf, -1);
  info[0] = vi->channels;
  info[1] = vi->rate;
  info[2] = total;
  v->ov_clear(ovf);
  return total > 0 ? 0 : -2;
}

// Decode the whole file into out (channels x total, channel-major).  Returns
// frames decoded; -1 means "hand this file to the Python pull loop" — on ANY
// anomaly (decode hole, link/format change, data past the declared total) the
// native path defers instead of guessing, so its error semantics are exactly
// the pull loop's (which raises on corrupt/chained-format streams).
int64_t ogg_decode_file(const char* path, float* out, int channels, int64_t total) {
  const VorbisFns* v = vorbis_fns();
  if (!v) return -1;
  alignas(16) char ovf[kOvfBytes];
  if (v->ov_fopen(path, ovf) != 0) return -1;
  int64_t pos = 0;
  int bitstream = 0;
  for (;;) {
    float** pcm = nullptr;
    long n = v->ov_read_float(ovf, &pcm, 4096, &bitstream);
    if (n == 0) {
      break;
    }
    if (n < 0 || bitstream != 0 || pos + n > total) {
      // hole / chained link / more data than the probe declared
      v->ov_clear(ovf);
      return -1;
    }
    for (int c = 0; c < channels; ++c)
      std::memcpy(out + (int64_t)c * total + pos, pcm[c], (size_t)n * sizeof(float));
    pos += n;
  }
  v->ov_clear(ovf);
  return pos;
}

}  // extern "C"
