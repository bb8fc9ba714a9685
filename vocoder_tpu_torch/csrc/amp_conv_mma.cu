// K2: one conv of a BigVGAN AMP stage with its anti-aliased Snake fused in,
// on the tensor cores.  One source, two routes, picked by the model's dtype:
//
// - bf16 (Bf16Op): every conv input is the fp32 aa-snake rounded to bf16
//   once, the weights are bf16, one mma.sync m16n8k16 per 16-channel step.
// - fp32 (Tf32x3Op, 3xTF32): fp32 aa-snake and fp32 weights, each operand
//   split at fragment load into tf32 hi = rna(v) and lo = rna(v - hi) (the
//   bits of cvt.rna.tf32.f32; without the rounding the tensor core truncates
//   the low 13 bits), and each 8-channel step is three mma.sync m16n8k8 tf32
//   products, lo·hi + hi·lo + hi·hi, small terms first.  tf32 x tf32 products
//   are exact in fp32 and lo·lo is below 2^-22 of a product, so the conv is
//   fp32-grade; hi·hi alone (one pass of TF32) keeps about three decimal
//   digits.
//
// Replaces the Pallas kernel vocoder_tpu/ops/pallas/amp_block.py::_kernel
// (pallas_call in amp_stage_fused), which ran a whole stage per time tile out
// of TPU VMEM and its convs on the matrix unit with operands in x's dtype and
// fp32 sums.  One launch is one conv of the chain, with the residual and
// block-sum epilogues of amp_conv.cuh; ops/amp_block.py keeps the residual
// stream and the stage sum in fp32 between launches.
//
// A conv is an implicit GEMM, M = time, N = output channel, K = input
// channel for each tap j:
//
//   out[t, o] = bias[o] + sum_j sum_i a[t + j dil - pad, i] w[j, o, i]
//
// Bound on an H100: the convs take 2 C K operations per output and channel
// on the tensor cores (989 TFLOP/s bf16; 495 TFLOP/s tf32, three passes for
// fp32), the aa-snake prologue ~104 fp32 operations per input element on the
// 67 TFLOP/s CUDA cores.  In bf16 the prologue sets the bound at C <= 64 and
// the convs above; in fp32 the three passes make the convs set it at every
// C >= 32.  What holds the kernel back on the card is the CUDA cores' side of
// the main loop as much as the tensor cores: the prologue, and in fp32 the
// operand splits, which cost as much as the MMAs themselves when written as
// cvt.rna (PERF.md).  The design keeps the work of each near its minimum:
//
// - A block is one batch item x kTime times x all C output channels
//   (C <= 256), 8 warps, fp32 accumulators in registers, so the prologue
//   runs once per input element plus the conv's halo dil (K - 1).  (The fp32
//   small tile above C = 128 takes 128 channels a block: see with_configs.)
// - Prologue: the time-major tile act[W][C + pad], W = kTime + dil (K - 1),
//   zero outside [0, T); the 16-byte pad puts the 8 rows of an ldmatrix in
//   distinct banks.  Each thread evaluates one channel's share of the W
//   rows (all of them at C = 256, a sixteenth at C = 16) in registers: one
//   load of x, two snakes and one decimating FIR a row, plus five pairs of
//   snakes to start, in aa_snake.cuh's arithmetic (the plain version's, to
//   the bit), and stores each value once: rounded to bf16, or as it is in
//   fp32.  No shared-memory staging and no barrier; a run near a sequence
//   edge runs the same loop with clamped reads (a slower edge path would set
//   the time of a launch whose blocks all run at once, as at b1).
// - Main loop: A fragments come from act by ldmatrix at row t + j dil, so a
//   tap's time shift is an address offset; B fragments by ldmatrix from a
//   ring of weight chunks.  An ldmatrix row is 16 bytes in both routes (8 bf16
//   or 4 fp32), and .b16 over 8 rows x 4 fp32 gives the m16n8k8 tf32 fragment
//   layout, so the addressing is the same.  Each step's products start from 0
//   and enter the fp32 sum by one IEEE-rounded add (mma_step).  fp32 splits
//   each fragment with integer operations (Tf32x3Op::tf32), not the cvt.
// - Weights are packed once per model as (K, C, C) in the model's dtype with
//   the input channel innermost, so a (tap, kc-channel) chunk is C rows of kc
//   contiguous values.  Chunks stream through a 3-slot shared-memory ring
//   with cp.async; the first two are in flight during the prologue, and each
//   later one while the chunk before it multiplies.
// - Epilogue: the accumulators go through shared memory as [o][t], so the
//   bias / residual / block-sum epilogue reads and writes (B, C, T) along T,
//   four values a thread (16-byte fp32 accesses) when T % 4 == 0.
//
// - An item of a padded batch has its own length L <= T (`lens`): the act
//   tile is aa_snake(x) clamped to [0, L) and 0 outside it, the epilogue
//   writes 0 at L <= t < T (a quad that straddles L zeros its lanes past L),
//   and a block whose time tile starts at or past L writes its zeros without
//   loading weights or x: every output it owns lies in the padding.  That
//   code is compiled only into amp_conv_mma_masked_kernel; a call without
//   lengths runs amp_conv_mma_kernel, which has none of it, so its machine
//   code stays that of the kernel before lengths (compiled into one kernel,
//   the length code cost the large tiles more spills at their register cap
//   and 3-5% of K2's b16 time on the H100).
//
// fp32 doubles the act tile and the ring, so the fp32 route picks its own
// tiles per channel class (with_configs).  When the large tile leaves the grid
// under two blocks per SM (b1 at the wider stages), the host takes a variant
// with a smaller time tile.

#include "amp_conv_io.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kRing = 3;  // weight ring slots

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc += d with one IEEE-rounded fp32 add each.  The tensor core sums a step's products from 0 and
// the running sum takes the step: accumulating inside the MMA drifts (its adds are not
// round-to-nearest), which a bf16 rounding of the next conv's input, or 90 fp32 convs, would amplify.
__device__ __forceinline__ void add_step(float (&acc)[4], float d0, float d1, float d2, float d3) {
  acc[0] = __fadd_rn(acc[0], d0);
  acc[1] = __fadd_rn(acc[1], d1);
  acc[2] = __fadd_rn(acc[2], d2);
  acc[3] = __fadd_rn(acc[3], d3);
}

// The bf16 route: one m16n8k16 a 16-channel step.
struct Bf16Op {
  using T = __nv_bfloat16;
  static constexpr int kDtype = aa::BF16;
  static constexpr int kVec = 8;    // elements in 16 bytes: an ldmatrix row and the row pad
  static constexpr int kStep = 16;  // input channels per MMA step
  struct Frag {
    uint32_t r[4];
  };
  static __device__ __forceinline__ T store(float v) { return __float2bfloat16(v); }
  static __device__ __forceinline__ Frag load(const T* p) {
    Frag f;
    ldsm_x4(f.r, p);
    return f;
  }
  // acc += A B for one 16-row x 8-column tile; B is the h-th 8-column half of b.
  template <int h>
  static __device__ __forceinline__ void mma_step(float (&acc)[4], const Frag& a, const Frag& b) {
    float d0, d1, d2, d3;
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %11, %12, %13};\n"
        : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[2 * h]), "r"(b.r[2 * h + 1]), "f"(0.0f),
          "f"(0.0f), "f"(0.0f), "f"(0.0f));
    add_step(acc, d0, d1, d2, d3);
  }
};

// The fp32 route: 3xTF32, three m16n8k8 an 8-channel step.
struct Tf32x3Op {
  using T = float;
  static constexpr int kDtype = aa::F32;
  static constexpr int kVec = 4;
  static constexpr int kStep = 8;
  struct Frag {
    uint32_t hi[4], lo[4];
  };
  static __device__ __forceinline__ T store(float v) { return v; }
  // cvt.rna.tf32.f32 for finite v: round to nearest, ties away from zero, by adding half of the
  // dropped 13 bits to the pattern and clearing them.  The same bits as the cvt in two integer
  // operations; written as the cvt, twice an operand, the split cost the main loop more than its
  // two extra MMAs on the H100 (PERF.md, k2_phases' cvt_split).
  static __device__ __forceinline__ uint32_t tf32(uint32_t bits) { return (bits + 0x1000u) & 0xFFFFE000u; }
  static __device__ __forceinline__ Frag load(const T* p) {
    uint32_t r[4];
    ldsm_x4(r, p);
    Frag f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f.hi[i] = tf32(r[i]);
      f.lo[i] = tf32(__float_as_uint(__fsub_rn(__uint_as_float(r[i]), __uint_as_float(f.hi[i]))));
    }
    return f;
  }
  static __device__ __forceinline__ void mma(float& d0, float& d1, float& d2, float& d3, const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  template <int h>
  static __device__ __forceinline__ void mma_step(float (&acc)[4], const Frag& a, const Frag& b) {
    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
    mma(d0, d1, d2, d3, a.lo, b.hi[2 * h], b.hi[2 * h + 1]);
    mma(d0, d1, d2, d3, a.hi, b.lo[2 * h], b.lo[2 * h + 1]);
    mma(d0, d1, d2, d3, a.hi, b.hi[2 * h], b.hi[2 * h + 1]);
    add_step(acc, d0, d1, d2, d3);
  }
};

// Warp grid WM x WN; each warp owns MT 16-row x NT 8-column MMA tiles.  A budget of 110 KB keeps
// two blocks on an SM; 200 KB (small tiles for grids under two blocks per SM, and fp32 at C = 256)
// may take most of one, and MINB = 1 then lets a thread keep up to 255 registers.  A block
// computes up to kCout output channels: all C when kCout >= C, else the blockIdx.z-th group of
// kCout (the last group takes what is left of C), each group computing the whole activation tile
// and streaming its share of the weights.
template <int WM_, int WN_, int MT_, int NT_, int BUDGET_KB, int MINB = 2>
struct Cfg {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, NT = NT_;
  static constexpr int kTime = WM * MT * 16;  // times per block
  static constexpr int kCout = WN * NT * 8;   // output channels per block
  static constexpr int kMinBlocks = MINB;
  static constexpr size_t kSmemBudget = BUDGET_KB * 1024;
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  static_assert(NT % 2 == 0, "B fragments load two 8-column tiles at a time");
};

struct Geometry {
  int W;    // activation rows: kTime + dil (K - 1)
  int lda;  // act row stride, elements
  int kc;   // input channels per ring chunk
  int ldb;  // ring row stride, elements
  size_t act_bytes, ring_bytes, smem_bytes;
};

template <class Op, class Cf>
__host__ __device__ inline Geometry geometry(int C, int K, int dil) {
  using T = typename Op::T;
  Geometry g;
  g.W = Cf::kTime + dil * (K - 1);
  g.lda = C + Op::kVec;
  g.act_bytes = sizeof(T) * static_cast<size_t>(g.W) * g.lda;
  // The widest weight chunk (input channels) that divides C and fits the budget beside act.
  for (g.kc = 64; g.kc > Op::kStep; g.kc /= 2) {
    const size_t ring = sizeof(T) * static_cast<size_t>(kRing) * Cf::kCout * (g.kc + Op::kVec);
    if (C % g.kc == 0 && g.act_bytes + ring <= Cf::kSmemBudget) break;
  }
  g.ldb = g.kc + Op::kVec;
  g.ring_bytes = sizeof(T) * static_cast<size_t>(kRing) * Cf::kCout * g.ldb;
  const size_t epi = sizeof(float) * static_cast<size_t>(C < Cf::kCout ? C : Cf::kCout) * (Cf::kTime + 4);
  const size_t main = g.act_bytes + g.ring_bytes;
  g.smem_bytes = main > epi ? main : epi;
  return g;
}

// One block of a conv: the kernels below.  kMasked takes item lengths from c.lens; without it every
// item is T long and none of the length code is compiled in.
template <class Op, class Cf, bool kMasked>
__device__ __forceinline__ void amp_conv_block(AmpConvParams p, CallArgs c) {
  using T = typename Op::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.C, K = p.K, dil = p.dil, T_len = c.T;
  const Geometry g = geometry<Op, Cf>(C, K, dil);
  T* act = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + g.act_bytes);

  const int t0 = blockIdx.x * Cf::kTime;
  const int64_t b = blockIdx.y;
  const int n0 = blockIdx.z * Cf::kCout;                    // first output channel of the block
  const int n_out = C - n0 < Cf::kCout ? C - n0 : Cf::kCout;  // its output channels
  const int p0 = t0 - dil * (K - 1) / 2;  // activation position of act row 0
  const T* w = static_cast<const T*>(p.w);
  [[maybe_unused]] int L = T_len;  // item b's length
  if constexpr (kMasked) {
    L = item_length(c, b);
    if (t0 >= L) {  // every output of the block lies in item b's padding
      for (int idx = threadIdx.x; idx < n_out * Cf::kTime; idx += kThreads) {
        const int o = idx / Cf::kTime, t = t0 + idx % Cf::kTime;
        if (t >= T_len) continue;
        const int64_t gi = (b * C + n0 + o) * T_len + t;
        if (c.out) c.out[gi] = 0.0f;
        if (c.fin) aa::st_any(c.fin, c.fin_dtype, gi, 0.0f);
        else if (c.acc_out) c.acc_out[gi] = 0.0f;
      }
      return;
    }
  }

  // Weight chunk q = (tap j, channels i0 .. i0 + kc) -> ring slot q % kRing.
  const int per_tap = C / g.kc, n_chunks = K * per_tap, pieces = g.kc / Op::kVec;
  auto load_chunk = [&](int q) {
    const int j = q / per_tap, i0 = (q - j * per_tap) * g.kc;
    const T* src = w + (static_cast<int64_t>(j) * C + n0) * C + i0;
    T* dst = ring + (q % kRing) * Cf::kCout * g.ldb;
    for (int idx = threadIdx.x; idx < n_out * pieces; idx += kThreads) {
      const int o = idx / pieces, pc = idx - o * pieces;
      cp_async16(dst + o * g.ldb + pc * Op::kVec, src + static_cast<int64_t>(o) * C + pc * Op::kVec);
    }
  };
#pragma unroll
  for (int q = 0; q < kRing - 1; ++q) {
    if (q < n_chunks) load_chunk(q);
    cp_async_commit();
  }

  // Prologue: act[s][i] = aa_snake(x)[b, i, p0 + s] in T, 0 outside [0, L).  Each thread takes
  // one channel and an equal share of its W rows; neighbouring threads take neighbouring channels.
  const int n_seg = C >= kThreads ? 1 : kThreads / C;
  const int seg_len = (g.W + n_seg - 1) / n_seg;
  if (threadIdx.x < C * n_seg) {
    const int ch = threadIdx.x % C, s0 = (threadIdx.x / C) * seg_len;
    const int len = min(seg_len, g.W - s0);
    if (len > 0) {
      const aa::Exact::Params ab = aa::Exact::params(p.alpha, p.beta, Op::kDtype, p.logscale, ch);
      const int64_t row = (b * C + ch) * T_len;
      T* col = act + s0 * g.lda + ch;
      if constexpr (kMasked) {
        const int n = min(len, L - (p0 + s0));  // rows before L; the rest are 0
        if (n > 0) {
          if (c.x_dtype == aa::BF16)
            act_rows<Op>(static_cast<const __nv_bfloat16*>(c.x) + row, L, p0 + s0, n, ab, col, g.lda);
          else
            act_rows<Op>(static_cast<const float*>(c.x) + row, L, p0 + s0, n, ab, col, g.lda);
        }
        for (int r = max(n, 0); r < len; ++r) col[r * g.lda] = Op::store(0.0f);
      } else {
        if (c.x_dtype == aa::BF16)
          act_rows<Op>(static_cast<const __nv_bfloat16*>(c.x) + row, T_len, p0 + s0, len, ab, col, g.lda);
        else
          act_rows<Op>(static_cast<const float*>(c.x) + row, T_len, p0 + s0, len, ab, col, g.lda);
      }
    }
  }

  // Main loop over the weight chunks.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m_base = (warp / Cf::WN) * Cf::MT * 16;
  const int n_base = (warp % Cf::WN) * Cf::NT * 8;
  const int a_row = lane % 16, a_col = (lane / 16) * Op::kVec;
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = ((lane / 8) % 2) * Op::kVec;
  float acc[Cf::MT][Cf::NT][4];
#pragma unroll
  for (int mt = 0; mt < Cf::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cf::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.0f;

  for (int q = 0; q < n_chunks; ++q) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // chunk q landed for every thread; slot (q - 1) % kRing is free
    if (q + kRing - 1 < n_chunks) load_chunk(q + kRing - 1);
    cp_async_commit();
    const int j = q / per_tap, i0 = (q - j * per_tap) * g.kc;
    const T* arow = act + (m_base + a_row + j * dil) * g.lda + i0 + a_col;
    const T* brow = ring + (q % kRing) * Cf::kCout * g.ldb + (n_base + b_row) * g.ldb + b_col;
    for (int kk = 0; kk < g.kc; kk += Op::kStep) {
      typename Op::Frag af[Cf::MT];
#pragma unroll
      for (int mt = 0; mt < Cf::MT; ++mt) af[mt] = Op::load(arow + mt * 16 * g.lda + kk);
#pragma unroll
      for (int np = 0; np < Cf::NT / 2; ++np) {
        const typename Op::Frag bf = Op::load(brow + np * 16 * g.ldb + kk);
#pragma unroll
        for (int mt = 0; mt < Cf::MT; ++mt) {
          Op::template mma_step<0>(acc[mt][2 * np], af[mt], bf);
          Op::template mma_step<1>(acc[mt][2 * np + 1], af[mt], bf);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and act are free: the epilogue reuses them

  // Epilogue: accumulators -> eb[o][t] (fp32), then along T to device memory.
  float* eb = reinterpret_cast<float*>(smem);
  constexpr int lde = Cf::kTime + 4;  // the 4 spreads a fragment's stores over the banks
#pragma unroll
  for (int mt = 0; mt < Cf::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cf::NT; ++nt) {
      const int t = m_base + mt * 16 + lane / 4;
      const int o = n_base + nt * 8 + 2 * (lane % 4);
      if (o < n_out) {  // columns past the block's channels (C not a multiple of kCout) hold nothing
        eb[o * lde + t] = acc[mt][nt][0];
        eb[(o + 1) * lde + t] = acc[mt][nt][1];
        eb[o * lde + t + 8] = acc[mt][nt][2];
        eb[(o + 1) * lde + t + 8] = acc[mt][nt][3];
      }
    }
  __syncthreads();
  const T* bias = static_cast<const T*>(p.bias);
  if constexpr (kMasked) L = item_length(c, b);  // read again: not held across the main loop
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(c.res) | reinterpret_cast<uintptr_t>(c.out) |
                         reinterpret_cast<uintptr_t>(c.acc_in) | reinterpret_cast<uintptr_t>(c.acc_out) |
                         reinterpret_cast<uintptr_t>(c.fin);
  if (T_len % 4 == 0 && ptrs % 16 == 0) {  // four times a thread, 16-byte fp32 accesses
    constexpr int kQuads = Cf::kTime / 4;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < n_out * kQuads; idx += kThreads) {
      const int o = idx / kQuads, r = (idx % kQuads) * 4;
      if (t0 + r >= T_len) continue;
      const int64_t gi = (b * C + n0 + o) * T_len + t0 + r;
      if constexpr (kMasked) {
        if (t0 + r + 4 > L) {  // a quad at or across item b's length
          masked_quad(p, c, eb + o * lde + r, aa::ld(bias, n0 + o), gi, L - (t0 + r));
          continue;
        }
      }
      const float bo = aa::ld(bias, n0 + o);
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
  for (int idx = threadIdx.x; idx < n_out * Cf::kTime; idx += kThreads) {
    const int o = idx / Cf::kTime, r = idx % Cf::kTime;
    const int t = t0 + r;
    if (t >= T_len) continue;
    const int64_t gi = (b * C + n0 + o) * T_len + t;
    if constexpr (kMasked) {
      if (t >= L) {  // item b's padding
        if (c.out) c.out[gi] = 0.0f;
        if (c.fin) aa::st_any(c.fin, c.fin_dtype, gi, 0.0f);
        else if (c.acc_out) c.acc_out[gi] = 0.0f;
        continue;
      }
    }
    float v = eb[o * lde + r] + aa::ld(bias, n0 + o);
    if (c.res) v += aa::ld_any(c.res, c.res_dtype, gi);
    if (c.out) c.out[gi] = v;
    if (c.acc_out || c.fin) {
      const float s = (c.acc_in ? c.acc_in[gi] : 0.0f) + v;
      if (c.fin) aa::st_any(c.fin, c.fin_dtype, gi, s / p.n_blocks);
      else c.acc_out[gi] = s;
    }
  }
}

template <class Op, class Cf>
__global__ void __launch_bounds__(kThreads, Cf::kMinBlocks) amp_conv_mma_kernel(AmpConvParams p, CallArgs c) {
  amp_conv_block<Op, Cf, false>(p, c);
}

// The same conv with per-item lengths (c.lens).
template <class Op, class Cf>
__global__ void __launch_bounds__(kThreads, Cf::kMinBlocks) amp_conv_mma_masked_kernel(AmpConvParams p, CallArgs c) {
  amp_conv_block<Op, Cf, true>(p, c);
}

constexpr int kMaxDevices = 64;

template <class Cf>
constexpr int groups(int C) {
  return (C + Cf::kCout - 1) / Cf::kCout;
}

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

template <class Op, class Cf, bool kMasked>
cudaError_t launch_kernel(const AmpConvParams& p, const CallArgs& c, int B, cudaStream_t stream) {
  const Geometry g = geometry<Op, Cf>(p.C, p.K, p.dil);
  auto kernel = kMasked ? amp_conv_mma_masked_kernel<Op, Cf> : amp_conv_mma_kernel<Op, Cf>;
  // The dynamic shared-memory cap (a cap, not a reservation) of this kernel is raised only when a
  // launch needs more.
  static int cap[kMaxDevices] = {};
  const int dev = current_device();
  const int need = static_cast<int>(g.smem_bytes);
  if (dev >= kMaxDevices || need > cap[dev]) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) cap[dev] = need;
  }
  dim3 grid((c.T + Cf::kTime - 1) / Cf::kTime, B, groups<Cf>(p.C));
  kernel<<<grid, kThreads, g.smem_bytes, stream>>>(p, c);
  return cudaGetLastError();
}

template <class Op, class Cf>
cudaError_t launch(const AmpConvParams& p, const CallArgs& c, int B, cudaStream_t stream) {
  return c.lens ? launch_kernel<Op, Cf, true>(p, c, B, stream) : launch_kernel<Op, Cf, false>(p, c, B, stream);
}

// The (large, small) tile configurations of each channel class and route.
template <class Op, class F>
auto with_configs(int C, F&& f) {
  if (C <= 16) return f(Cfg<8, 1, 2, 2, 110>{}, Cfg<8, 1, 1, 2, 200>{});
  if (C <= 32) return f(Cfg<8, 1, 2, 4, 110>{}, Cfg<8, 1, 1, 4, 200>{});
  if (C <= 64) return f(Cfg<8, 1, 2, 8, 110>{}, Cfg<8, 1, 1, 8, 200>{});
  if constexpr (std::is_same_v<Op, Bf16Op>) {
    if (C <= 128) return f(Cfg<4, 2, 2, 8, 110>{}, Cfg<4, 2, 1, 8, 200>{});
    return f(Cfg<2, 4, 2, 8, 110>{}, Cfg<1, 8, 1, 4, 200>{});
  } else {
    // fp32 holds the bf16 tiles up to C = 128 (at C = 128 the widest halo leaves an 8-channel
    // chunk), with the small C = 128 tile kept at two blocks an SM.  At C = 256 a 64-time tile's
    // act alone is 119 KB, so the large tile takes one block an SM (and up to 255 registers); the
    // small one computes 32 times x 128 channels (two channel groups over grid.z, the second
    // smaller below C = 256), so that each block streams at most half the weights (fp32 weights
    // from L2 set the pace there).
    if (C <= 128) return f(Cfg<4, 2, 2, 8, 110>{}, Cfg<4, 2, 1, 8, 110>{});
    return f(Cfg<2, 4, 2, 8, 200, 1>{}, Cfg<2, 4, 1, 4, 200>{});
  }
}

// Blocks a launch of configuration Cf runs at (C, B, T).
template <class Cf>
int64_t blocks(int C, int B, int T) {
  return static_cast<int64_t>(B) * ((T + Cf::kTime - 1) / Cf::kTime) * groups<Cf>(C);
}

// The small tile when the large one leaves the grid under two blocks per SM.
bool small_grid(int64_t big_blocks) {
  static int sm_count[kMaxDevices] = {};
  const int dev = current_device();
  int sms = dev < kMaxDevices ? sm_count[dev] : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (dev < kMaxDevices) sm_count[dev] = sms;
  }
  return big_blocks < 2 * static_cast<int64_t>(sms);
}

template <class Op>
cudaError_t dispatch(const AmpConvParams& p, const CallArgs& c, int B, cudaStream_t s) {
  return with_configs<Op>(p.C, [&](auto big, auto small) -> cudaError_t {
    using Big = decltype(big);
    using Small = decltype(small);
    return small_grid(blocks<Big>(p.C, B, c.T)) ? launch<Op, Small>(p, c, B, s) : launch<Op, Big>(p, c, B, s);
  });
}

template <class Op>
void launch_shape(int C, int B, int T, int* shape) {
  with_configs<Op>(C, [&](auto big, auto small) -> int {
    using Big = decltype(big);
    using Small = decltype(small);
    const bool sm = small_grid(blocks<Big>(C, B, T));
    shape[0] = sm ? Small::kTime : Big::kTime;
    shape[1] = static_cast<int>(sm ? blocks<Small>(C, B, T) : blocks<Big>(C, B, T));
    return 0;
  });
}

}  // namespace

// One conv of an AMP chain (amp_conv.cuh), w packed as (K, C, C).  bf16 parameters take x in bf16
// or fp32 (the bf16 route); fp32 parameters take fp32 x (the 3xTF32 route).  C must be a multiple
// of 16 and at most 256, K odd.  lens: the device int32 (B,) item lengths, clamped to [0, T], or
// nullptr for every item T long.
extern "C" int amp_conv_fwd(const AmpConvParams* p, const void* x, int x_dtype, int B, int T, const void* res,
                            int res_dtype, float* out, const float* acc_in, float* acc_out, void* fin, int fin_dtype,
                            const int* lens, void* stream) {
  const bool bf16 = p->param_dtype == aa::BF16;
  const bool dtypes = bf16 ? (x_dtype == aa::BF16 || x_dtype == aa::F32)
                           : (p->param_dtype == aa::F32 && x_dtype == aa::F32);
  if (!dtypes || B <= 0 || B > 65535 || p->C <= 0 || p->C % 16 != 0 || p->C > 256 || T <= 0 || p->K <= 0 ||
      p->K % 2 == 0 || p->dil <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const CallArgs c{x, x_dtype, T, res, res_dtype, out, acc_in, acc_out, fin, fin_dtype, lens};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? dispatch<Bf16Op>(*p, c, B, s) : dispatch<Tf32x3Op>(*p, c, B, s));
}

// shape = (time tile, blocks) of a launch of the param_dtype route at (C, B, T); returns 0, or
// cudaErrorInvalidValue for arguments amp_conv_fwd does not take.
extern "C" int amp_conv_launch_shape(int param_dtype, int C, int B, int T, int* shape) {
  if ((param_dtype != aa::BF16 && param_dtype != aa::F32) || C <= 0 || C % 16 != 0 || C > 256 || B <= 0 ||
      B > 65535 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (param_dtype == aa::BF16) launch_shape<Bf16Op>(C, B, T, shape);
  else launch_shape<Tf32x3Op>(C, B, T, shape);
  return 0;
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
