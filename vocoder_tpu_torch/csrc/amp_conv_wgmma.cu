// K2's fp32 route (3xTF32) on Hopper's warpgroup MMA: one conv of a BigVGAN AMP stage with its
// anti-aliased Snake fused in, as amp_conv_mma.cu's Tf32x3Op computes it, with the main loop
// rebuilt on TMA and wgmma.  ops/amp_block.py takes it at C = 64, 128 and 256 (the shape rule
// there); amp_conv_mma.cu's mma.sync kernel keeps the other widths, C = 256 at short b1 grids and
// the bf16 route.  Same arguments (amp_conv.cuh), same prologue (amp_conv_io.cuh) and epilogue (a
// copy of amp_conv_mma.cu's), so the two kernels agree to the fp32 rounding of their sums.
//
// Replaces, like amp_conv_mma.cu, the Pallas kernel vocoder_tpu/ops/pallas/amp_block.py::_kernel.
//
// Bound on an H100: operations.  Three tf32 passes of the conv, 3 x 2 C K per output and channel at
// 495 TFLOP/s, beside the aa-snake prologue on the CUDA cores (~104 fp32 operations per input
// element).  The mma.sync kernel ran the main loop at ~30% of the three passes' ceiling: every warp
// loaded and split its own B fragments, and each A fragment fed 8 column tiles at most.  Here:
//
// - Weights: ops/amp_block.py packs each conv once per model as (2, K, C, C), the tf32 hi and lo
//   halves of w[j, o, i] (ops/linear_3xtf32.py::tf32_split, K3's split), and encodes a TMA map of
//   it as (2 K C) rows of C.  A chunk is one tap j and BK input channels: a box of BK x C from each
//   half (hi at row j C, lo at row (K + j) C), swizzled, into a ring of S stages.  One producer
//   warp keeps the chunks in flight (mbarrier full/empty pairs); the first S are issued before the
//   prologue, so they land while it runs.
// - Products: consumer warpgroups run wgmma.mma_async m64nNWk8 tf32 with B (the halves) read from
//   shared memory and A from registers: each warp's 16 x 8 fragment comes from the act tile by
//   ldmatrix at row t + j dil (a tap's shift is an address offset, as in the mma.sync kernel) and
//   is split there into hi and lo, once for all NW output channels of the instruction.  Each
//   8-deep step is three products, lo·hi + hi·lo + hi·hi, small terms first; a chunk's products
//   start from zero in a partial sum that enters the running sum by IEEE-rounded fp32 adds (the
//   tensor core's own adds drift over K's 3-11 x C terms).  Two consumer warpgroups take turns
//   (named barriers, as K3's): one issues its chunk's products while the other adds, frees its
//   slot and splits its next A.
// - Prologue and epilogue as in amp_conv_mma.cu: the fp32 act tile act[W][C + 4], W = kTime +
//   dil (K - 1), in the plain version's arithmetic; the sums through shared memory as [o][t] to
//   the bias / residual / block-sum epilogue; blocks wholly in an item's padding write zeros.
//
// Tiles (Cfg), one block a (time tile, item) with all C output channels, so the prologue runs once
// per input element plus the halo.  Shared memory is the constraint: act is up to 119 KB at C =
// 256 for 64 times (halo 50 at K = 11, dil = 5), and a stage holds C x BK of both halves.
// Registers: a warpgroup's 64 x NW sums take NW / 2 a thread, twice (running and partial sums).
//
//   C     warpgroups       time tile  NW   BK (swizzle)  stages  shared memory (largest halo)  blocks an SM
//   64    2 along time     128        64   16 (64 B)     4       1 + 32 + 48 KB = 81 KB       2
//   128   2 along time     128        128  32 (128 B)    3       1 + 96 + 94 KB = 191 KB      1
//   256   2 along channels 64         128  16 (64 B)     3       1 + 96 + 119 KB = 216 KB     1
//
// At C = 64 the prologue costs as much as a third of the main loop, so two blocks share an SM and
// one's prologue runs beside the other's products (95 registers a thread; 15% faster on the H100
// than one block of 32-deep chunks).  Wider stages take one block an SM: their tiles fill shared
// memory, and smaller ones were slower (at C = 128 one consumer warpgroup with two blocks an SM,
// 15-18%; at C = 256 a 2-stage ring, 11%).
// ops/amp_block.py's shape rule keeps the mma.sync kernel where it is the faster: C = 256 at grids
// of a quarter of the SMs or less (b1 under ~3 s of audio), which its small tile runs in one wave.

#include "amp_conv_io.cuh"
#include "hopper.cuh"

#include <string.h>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 227 * 1024;

// C channels; two consumer warpgroups, WGM x WGN along time x output channels; BK input channels a
// chunk; S ring stages; MINB blocks an SM.
template <int C_, int WGM_, int WGN_, int BK_, int S_, int MINB_ = 1>
struct Cfg {
  static constexpr int C = C_, WGM = WGM_, WGN = WGN_, BK = BK_, S = S_, kMinBlocks = MINB_;
  static constexpr int kConsumers = 2;
  static constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
  static constexpr int kTime = 64 * WGM;                   // times a block
  static constexpr int NW = C / WGN;                       // output channels a warpgroup
  static constexpr int kAcc = NW / 2;                      // sums a thread, each of running and partial
  static constexpr int kSteps = BK / 8;                    // 8-deep steps a chunk
  static constexpr int kHalf = C * BK * 4;                 // one half's box
  static constexpr int kStage = 2 * kHalf;
  static constexpr int kRing = S * kStage;
  static constexpr int kLda = C + 4;  // act row stride: the 16-byte pad puts an ldmatrix's 8 rows in distinct banks
  static_assert(BK == 16 || BK == 32, "a chunk is one 64- or 128-byte swizzle row");
  static_assert(NW == 64 || NW == 128, "wgmma widths 64 and 128");
  static_assert(WGM * WGN == kConsumers, "two consumer warpgroups, taking turns");
};

// amp_conv_mma.cu's epilogue for a block of all C output channels, as two functions; that file
// keeps its own inline copy, since factoring it out changed 9-22 instructions of each of its
// kernels (tools/sass_diff.py).
//
// A block whose time tile starts at or past item b's length L: every output it owns lies in the
// padding, so it writes its zeros (times t0 .. t0 + kTime) without loading weights or x.
template <int C, int kThreads, int kTime>
__device__ __forceinline__ void zero_tile(const CallArgs& c, int64_t b, int t0) {
  for (int idx = threadIdx.x; idx < C * kTime; idx += kThreads) {
    const int o = idx / kTime, t = t0 + idx % kTime;
    if (t >= c.T) continue;
    const int64_t gi = (b * C + o) * c.T + t;
    if (c.out) c.out[gi] = 0.0f;
    if (c.fin) aa::st_any(c.fin, c.fin_dtype, gi, 0.0f);
    else if (c.acc_out) c.acc_out[gi] = 0.0f;
  }
}

// Epilogue: the block's conv outputs eb[o][t] (fp32 in shared memory, row stride kTime + 4) plus
// bias and the call's residual, block sum and stage output, along T to device memory; with kMasked,
// 0 from item b's length on.
template <int C, int kThreads, int kTime, bool kMasked>
__device__ __forceinline__ void store_tile(const AmpConvParams& p, const CallArgs& c, const float* eb, int64_t b,
                                           int t0) {
  constexpr int lde = kTime + 4;
  const float* bias = static_cast<const float*>(p.bias);
  const int T_len = c.T;
  [[maybe_unused]] int L = T_len;
  if constexpr (kMasked) L = item_length(c, b);  // read again: not held across the main loop
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(c.res) | reinterpret_cast<uintptr_t>(c.out) |
                         reinterpret_cast<uintptr_t>(c.acc_in) | reinterpret_cast<uintptr_t>(c.acc_out) |
                         reinterpret_cast<uintptr_t>(c.fin);
  if (T_len % 4 == 0 && ptrs % 16 == 0) {  // four times a thread, 16-byte fp32 accesses
    constexpr int kQuads = kTime / 4;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < C * kQuads; idx += kThreads) {
      const int o = idx / kQuads, r = (idx % kQuads) * 4;
      if (t0 + r >= T_len) continue;
      const int64_t gi = (b * C + o) * T_len + t0 + r;
      if constexpr (kMasked) {
        if (t0 + r + 4 > L) {  // a quad at or across item b's length
          masked_quad(p, c, eb + o * lde + r, bias[o], gi, L - (t0 + r));
          continue;
        }
      }
      const float bo = bias[o];
      float4 v = *reinterpret_cast<const float4*>(eb + o * lde + r);
      v = make_float4(v.x + bo, v.y + bo, v.z + bo, v.w + bo);
      if (c.res) v = add4(v, ld4(c.res, c.res_dtype, gi));
      if (c.out) st4(c.out, aa::F32, gi, v);
      if (c.acc_out || c.fin) {
        const float4 s = c.acc_in ? add4(ld4(c.acc_in, aa::F32, gi), v) : v;
        if (c.fin) {
          const float n = p.n_blocks;
          st4(c.fin, c.fin_dtype, gi, make_float4(s.x / n, s.y / n, s.z / n, s.w / n));
        } else {
          st4(c.acc_out, aa::F32, gi, s);
        }
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < C * kTime; idx += kThreads) {
    const int o = idx / kTime, r = idx % kTime;
    const int t = t0 + r;
    if (t >= T_len) continue;
    const int64_t gi = (b * C + o) * T_len + t;
    if constexpr (kMasked) {
      if (t >= L) {  // item b's padding
        if (c.out) c.out[gi] = 0.0f;
        if (c.fin) aa::st_any(c.fin, c.fin_dtype, gi, 0.0f);
        else if (c.acc_out) c.acc_out[gi] = 0.0f;
        continue;
      }
    }
    float v = eb[o * lde + r] + bias[o];
    if (c.res) v += aa::ld_any(c.res, c.res_dtype, gi);
    if (c.out) c.out[gi] = v;
    if (c.acc_out || c.fin) {
      const float s = (c.acc_in ? c.acc_in[gi] : 0.0f) + v;
      if (c.fin) aa::st_any(c.fin, c.fin_dtype, gi, s / p.n_blocks);
      else c.acc_out[gi] = s;
    }
  }
}

// The fp32 act tile's element type and store (amp_conv_io.cuh's ColOut).
struct F32Act {
  using T = float;
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <class Cf>
__host__ __device__ inline size_t smem_bytes(int K, int dil) {
  return 1024 + Cf::kRing + sizeof(float) * static_cast<size_t>(Cf::kTime + dil * (K - 1)) * Cf::kLda +
         16 * Cf::S;
}

template <int BK>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  if constexpr (BK == 32) return b128_desc(addr);
  else return b64_desc(addr);
}

// Named barrier 3 over the two consumer warpgroups: both are done with act and the ring.
__device__ __forceinline__ void consumers_done() { asm volatile("bar.sync 3, 256;\n" ::: "memory"); }

template <class Cf, bool kMasked>
__device__ __forceinline__ void wgmma_block(const AmpConvParams& p, const CUtensorMap* map, const CallArgs& c) {
  constexpr int C = Cf::C;
  extern __shared__ uint8_t smem_raw[];
  const int K = p.K, dil = p.dil, T_len = c.T;
  const int t0 = blockIdx.x * Cf::kTime;
  const int64_t b = blockIdx.y;
  const int W = Cf::kTime + dil * (K - 1);  // act rows
  const int p0 = t0 - dil * (K - 1) / 2;    // activation position of act row 0
  [[maybe_unused]] int L = T_len;           // item b's length
  if constexpr (kMasked) {
    L = item_length(c, b);
    if (t0 >= L) {  // every output of the block lies in item b's padding
      zero_tile<C, Cf::kThreads, Cf::kTime>(c, b, t0);
      return;
    }
  }
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  uint8_t* const smem = smem_raw + (base - raw);
  float* const act = reinterpret_cast<float*>(smem + Cf::kRing);
  const uint32_t bars = base + Cf::kRing + sizeof(float) * W * Cf::kLda;  // full[s] at 8 s, empty[s] at 8 (S + s)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool producer = warp == 4 * Cf::kConsumers;
  const int per_tap = C / Cf::BK, n_chunks = K * per_tap;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::S; ++s) {
      mbar_init(bars + 8 * s, 1);                              // the producer's expect_tx
      mbar_init(bars + 8 * (Cf::S + s), 4 * Cf::kConsumers);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Chunk q = (tap j, input channels i0 .. i0 + BK) into stage s: both halves' boxes.
  int ps = 0, q_next = 0;
  uint32_t pphase = 0;
  auto issue = [&](int q) {
    const int j = q / per_tap, i0 = (q - j * per_tap) * Cf::BK;
    const uint32_t full = bars + 8 * ps, st = base + ps * Cf::kStage;
    mbar_expect_tx(full, Cf::kStage);
    tma_load(st, map, i0, j * C, full);
    tma_load(st + Cf::kHalf, map, i0, (K + j) * C, full);
    if (++ps == Cf::S) {
      ps = 0;
      pphase ^= 1;
    }
  };
  if (producer && lane == 0) {
    for (; q_next < Cf::S && q_next < n_chunks; ++q_next) issue(q_next);  // every slot starts free
  }

  // Prologue: act[s][i] = aa_snake(x)[b, i, p0 + s], 0 outside [0, L).  Each thread takes one
  // channel and an equal share of its W rows; neighbouring threads take neighbouring channels.
  constexpr int kSeg = Cf::kThreads / C > 0 ? Cf::kThreads / C : 1;
  const int seg_len = (W + kSeg - 1) / kSeg;
  if (threadIdx.x < C * kSeg) {
    const int ch = threadIdx.x % C, s0 = (threadIdx.x / C) * seg_len;
    const int len = min(seg_len, W - s0);
    if (len > 0) {
      const aa::Exact::Params ab = aa::Exact::params(p.alpha, p.beta, aa::F32, p.logscale, ch);
      const float* xrow = static_cast<const float*>(c.x) + (b * C + ch) * T_len;
      float* col = act + s0 * Cf::kLda + ch;
      if constexpr (kMasked) {
        const int n = min(len, L - (p0 + s0));  // rows before L; the rest are 0
        if (n > 0) act_rows<F32Act>(xrow, L, p0 + s0, n, ab, col, Cf::kLda);
        for (int r = max(n, 0); r < len; ++r) col[r * Cf::kLda] = 0.0f;
      } else {
        act_rows<F32Act>(xrow, T_len, p0 + s0, len, ab, col, Cf::kLda);
      }
    }
  }
  __syncthreads();  // act is whole

  float* const eb = reinterpret_cast<float*>(smem);  // the epilogue's [o][t] tile, over the ring and act
  constexpr int lde = Cf::kTime + 4;                 // the 4 spreads a fragment's stores over the banks
  if (producer) {
    if (lane == 0) {
      for (; q_next < n_chunks; ++q_next) {
        mbar_wait(bars + 8 * (Cf::S + ps), pphase ^ 1);  // the slot's last readers are done
        issue(q_next);
      }
    }
  } else {
    const int wg = warp / 4, wgm = wg / Cf::WGN, wgn = wg % Cf::WGN;
    const int a_row = wgm * 64 + (warp % 4) * 16 + lane % 16, a_col = (lane / 16) * 4;
    float acc[Cf::kAcc], part[Cf::kAcc];
#pragma unroll
    for (int i = 0; i < Cf::kAcc; ++i) acc[i] = 0.0f;
    int s = 0;
    uint32_t phase = 0;
    for (int q = 0; q < n_chunks; ++q) {
      const int j = q / per_tap, i0 = (q - j * per_tap) * Cf::BK;
      const float* arow = act + (a_row + j * dil) * Cf::kLda + i0 + a_col;
      mbar_wait(bars + 8 * s, phase);
      // A fragments of the chunk's 8-deep steps (ldmatrix .b16 over 8 rows x 4 fp32 gives the tf32
      // layout: a[v + 2h] holds row 8 v + lane / 4 of the warp's 16, depth 8 kk + lane % 4 + 4 h),
      // split into tf32 hi and lo.
      uint32_t hi[Cf::kSteps][4], lo[Cf::kSteps][4];
#pragma unroll
      for (int kk = 0; kk < Cf::kSteps; ++kk) {
        uint32_t r[4];
        ldsm_x4(r, arow + 8 * kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[kk][i] = tf32_rna(r[i]);
          lo[kk][i] = tf32_rna(__float_as_uint(__fsub_rn(__uint_as_float(r[i]), __uint_as_float(hi[kk][i]))));
        }
        fence_regs(hi[kk]);
        fence_regs(lo[kk]);
      }
      const uint32_t b_hi = base + s * Cf::kStage + wgn * Cf::NW * Cf::BK * 4, b_lo = b_hi + Cf::kHalf;
      if (wg == 1 || q > 0) named_sync(wg == 0 ? 2 : 1);  // the other warpgroup issued before us
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Cf::kSteps; ++kk) {  // the chunk's products start from zero (part)
        wgmma<Cf::NW>(part, lo[kk], b_desc<Cf::BK>(b_hi + 32 * kk), kk > 0);
        wgmma<Cf::NW>(part, hi[kk], b_desc<Cf::BK>(b_lo + 32 * kk), 1);
        wgmma<Cf::NW>(part, hi[kk], b_desc<Cf::BK>(b_hi + 32 * kk), 1);
      }
      wgmma_commit();
      named_arrive(wg == 0 ? 1 : 2);
      wgmma_wait0();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < Cf::kAcc; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (Cf::S + s));
      if (++s == Cf::S) {
        s = 0;
        phase ^= 1;
      }
    }
    if (wg == 0 && n_chunks > 0) named_sync(2);  // warpgroup 1's last arrive, so no barrier is left half-met
    consumers_done();  // act and the ring are free: eb reuses them
    // acc[4 jn + 2 v + e] is row 8 v + lane / 4 of the warp's 16, column 8 jn + 2 (lane % 4) + e.
    const int t = wgm * 64 + (warp % 4) * 16 + lane / 4, o = wgn * Cf::NW + 2 * (lane % 4);
#pragma unroll
    for (int jn = 0; jn < Cf::NW / 8; ++jn)
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int e = 0; e < 2; ++e) eb[(o + 8 * jn + e) * lde + t + 8 * v] = acc[4 * jn + 2 * v + e];
  }
  __syncthreads();
  store_tile<C, Cf::kThreads, Cf::kTime, kMasked>(p, c, eb, b, t0);
}

template <class Cf>
__global__ void __launch_bounds__(Cf::kThreads, Cf::kMinBlocks)
    amp_conv_mma_wgmma_kernel(const AmpConvParams p, const __grid_constant__ CUtensorMap map, const CallArgs c) {
  wgmma_block<Cf, false>(p, &map, c);
}

// The same conv with per-item lengths (c.lens).
template <class Cf>
__global__ void __launch_bounds__(Cf::kThreads, Cf::kMinBlocks)
    amp_conv_mma_wgmma_masked_kernel(const AmpConvParams p, const __grid_constant__ CUtensorMap map,
                                     const CallArgs c) {
  wgmma_block<Cf, true>(p, &map, c);
}

// The tile configuration of each channel class (the header's table); false where there is none.
template <class F>
bool with_config(int C, F&& f) {
  if (C == 64) return f(Cfg<64, 2, 1, 16, 4, 2>{}), true;
  if (C == 128) return f(Cfg<128, 2, 1, 32, 3>{}), true;
  if (C == 256) return f(Cfg<256, 1, 2, 16, 3>{}), true;
  return false;
}

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

template <class Cf, bool kMasked>
cudaError_t launch(const AmpConvParams& p, const CUtensorMap& map, const CallArgs& c, int B, cudaStream_t stream) {
  auto kernel = kMasked ? amp_conv_mma_wgmma_masked_kernel<Cf> : amp_conv_mma_wgmma_kernel<Cf>;
  // The dynamic shared-memory cap (a cap, not a reservation) of this kernel is raised only when a
  // launch needs more.
  static int cap[kMaxDevices] = {};
  const int dev = current_device();
  const int need = static_cast<int>(smem_bytes<Cf>(p.K, p.dil));
  if (dev >= kMaxDevices || need > cap[dev]) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) cap[dev] = need;
  }
  dim3 grid((c.T + Cf::kTime - 1) / Cf::kTime, B, 1);
  kernel<<<grid, Cf::kThreads, need, stream>>>(p, map, c);
  return cudaGetLastError();
}

}  // namespace

static_assert(sizeof(CUtensorMap) == 128, "ops/amp_block.py keeps a map in 128 bytes");

// Whether the kernel takes a conv of C channels, kernel size K and dilation dil: a tile
// configuration for C whose act tile and ring fit in shared memory.  If so, *map takes the TMA map
// of its (2, K, C, C) halves (ops/amp_block.py's pack) and 0 is returned; -1 where the kernel does
// not take the conv; a CUDA error code where the map cannot be made.  Called once per conv and
// model state, when its plan is built.
extern "C" int amp_conv_wgmma_map(const float* halves, int C, int K, int dil, void* map) {
  if (K <= 0 || K % 2 == 0 || dil <= 0) return static_cast<int>(cudaErrorInvalidValue);
  bool fits = false;
  int bk = 0;
  if (!with_config(C, [&](auto cfg) {
        using Cf = decltype(cfg);
        fits = smem_bytes<Cf>(K, dil) <= kMaxSmem;
        bk = Cf::BK;
      }) ||
      !fits)
    return -1;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap m;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C), 2ull * K * C};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(bk), static_cast<cuuint32_t>(C)};
  const cuuint32_t step[2] = {1, 1};
  if (enc(&m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(halves), dims, strides, box, step,
          CU_TENSOR_MAP_INTERLEAVE_NONE, bk == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  memcpy(map, &m, sizeof m);
  return 0;
}

// One conv of an AMP chain (amp_conv.cuh) on fp32 parameters and fp32 x, its weights read through
// map (amp_conv_wgmma_map); the other arguments as amp_conv_fwd's in amp_conv_mma.cu.
extern "C" int amp_conv_wgmma_fwd(const AmpConvParams* p, const void* map, const void* x, int x_dtype, int B, int T,
                                  const void* res, int res_dtype, float* out, const float* acc_in, float* acc_out,
                                  void* fin, int fin_dtype, const int* lens, void* stream) {
  if (p->param_dtype != aa::F32 || x_dtype != aa::F32 || B <= 0 || B > 65535 || T <= 0 || p->K <= 0 ||
      p->K % 2 == 0 || p->dil <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m;
  memcpy(&m, map, sizeof m);
  const CallArgs c{x, x_dtype, T, res, res_dtype, out, acc_in, acc_out, fin, fin_dtype, lens};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  with_config(p->C, [&](auto cfg) {
    using Cf = decltype(cfg);
    if (smem_bytes<Cf>(p->K, p->dil) > kMaxSmem) return;
    err = lens ? launch<Cf, true>(*p, m, c, B, s) : launch<Cf, false>(*p, m, c, B, s);
  });
  return static_cast<int>(err);
}

// shape = (time tile, blocks) of a launch at (C, B, T); returns 0, or cudaErrorInvalidValue for a C the
// kernel does not take.
extern "C" int amp_conv_wgmma_launch_shape(int C, int B, int T, int* shape) {
  if (B <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool taken = with_config(C, [&](auto cfg) {
    using Cf = decltype(cfg);
    shape[0] = Cf::kTime;
    shape[1] = B * ((T + Cf::kTime - 1) / Cf::kTime);
  });
  return taken ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
