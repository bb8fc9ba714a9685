// K2, bf16 route: one conv of a BigVGAN AMP stage with its anti-aliased
// Snake fused in, on the tensor cores.
//
// Replaces, with amp_stage.cu (the fp32 route), the Pallas kernel
// vocoder_tpu/ops/pallas/amp_block.py::_kernel (pallas_call in
// amp_stage_fused), which ran a whole stage per time tile out of TPU VMEM
// and its convs on the matrix unit with bf16 operands and fp32 sums.  The
// same rule holds here: every conv input is the fp32 aa-snake rounded to
// bf16 once, and the sums are fp32.  One launch is one conv of the chain,
// with the residual and block-sum epilogues of amp_conv.cuh; ops/amp_block.py
// keeps the residual stream and the stage sum in fp32 between launches.
//
// A conv is an implicit GEMM, M = time, N = output channel, K = input
// channel for each tap j:
//
//   out[t, o] = bias[o] + sum_j sum_i a[t + j dil - pad, i] w[j, o, i]
//
// Bound on an H100: the convs take 2 C K operations per output and channel
// on the 989 TFLOP/s bf16 tensor cores, the aa-snake prologue ~104 fp32
// operations per input element on the 67 TFLOP/s CUDA cores.  The prologue
// sets the bound at C <= 64, the convs above.  The design keeps the work of
// each near its minimum:
//
// - A block is one batch item x kTime times x all C output channels
//   (C <= 256), 8 warps, fp32 accumulators in registers, so the prologue
//   runs once per input element plus the conv's halo dil (K - 1).
// - Prologue: the time-major bf16 tile act[W][C + 8], W = kTime + dil (K - 1),
//   zero outside [0, T); the +8 pad puts the 8 rows of an ldmatrix in
//   distinct banks.  Each thread evaluates one channel's share of the W
//   rows (all of them at C = 256, a sixteenth at C = 16) in registers: one
//   load of x, two snakes and one decimating FIR a row, plus five pairs of
//   snakes to start, in aa_snake.cuh's arithmetic (the plain version's, to
//   the bit), and rounds each value to bf16 once, at the store.  No
//   shared-memory staging and no barrier; a run near a sequence edge runs
//   the same loop with clamped reads (a slower edge path would set the time
//   of a launch whose blocks all run at once, as at b1).
// - Main loop: mma.sync m16n8k16 (bf16 x bf16 -> fp32).  A fragments come
//   from act by ldmatrix at row t + j dil, so a tap's time shift is an
//   address offset; B fragments by ldmatrix from a ring of weight chunks.
// - Weights are packed once per model as bf16 (K, C, C) with the input
//   channel innermost, so a (tap, KC-channel) chunk is C rows of KC
//   contiguous values.  Chunks stream through a 3-slot shared-memory ring
//   with cp.async; the first two are in flight during the prologue, and each
//   later one while the chunk before it multiplies.
// - Epilogue: the accumulators go through shared memory as [o][t], so the
//   bias / residual / block-sum epilogue reads and writes (B, C, T) along T,
//   four values a thread (16-byte fp32 accesses) when T % 4 == 0.
//
// When the large tile leaves the grid under two blocks per SM (b1 at the
// wider stages), the host takes a variant with a smaller time tile.

#include "aa_snake.cuh"
#include "amp_conv.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRing = 3;          // weight ring slots

// Warp grid WM x WN; each warp owns MT 16-row x NT 8-column MMA tiles.  The large tiles keep
// their shared memory under half an SM's, so two blocks share one; a small tile (for grids
// under two blocks per SM) may take most of one.
template <int WM_, int WN_, int MT_, int NT_, bool SMALL_>
struct Cfg {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, NT = NT_;
  static constexpr int kTime = WM * MT * 16;  // times per block
  static constexpr int kCout = WN * NT * 8;   // output channels per block, >= C
  static constexpr size_t kSmemBudget = SMALL_ ? 200 * 1024 : 110 * 1024;
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  static_assert(NT % 2 == 0, "B fragments load two 8-column tiles at a time");
};

struct Geometry {
  int W;       // activation rows: kTime + dil (K - 1)
  int lda;     // act row stride, bf16 elements
  int kc;      // input channels per ring chunk
  int ldb;     // ring row stride, bf16 elements
  size_t act_bytes, ring_bytes, smem_bytes;
};

template <class Cf>
__host__ __device__ inline Geometry geometry(int C, int K, int dil) {
  Geometry g;
  g.W = Cf::kTime + dil * (K - 1);
  g.lda = C + 8;
  g.act_bytes = sizeof(__nv_bfloat16) * static_cast<size_t>(g.W) * g.lda;
  // The widest weight chunk (input channels) that divides C and fits the budget beside act.
  for (g.kc = 64; g.kc > 16; g.kc /= 2) {
    const size_t ring = sizeof(__nv_bfloat16) * static_cast<size_t>(kRing) * Cf::kCout * (g.kc + 8);
    if (C % g.kc == 0 && g.act_bytes + ring <= Cf::kSmemBudget) break;
  }
  g.ldb = g.kc + 8;
  g.ring_bytes = sizeof(__nv_bfloat16) * static_cast<size_t>(kRing) * Cf::kCout * g.ldb;
  const size_t epi = sizeof(float) * static_cast<size_t>(C) * (Cf::kTime + 4);
  const size_t main = g.act_bytes + g.ring_bytes;
  g.smem_bytes = main > epi ? main : epi;
  return g;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// acc += A B over one 16-deep step.  The tensor core sums the step's 16 products from 0 and the
// running sum takes one IEEE-rounded fp32 add: accumulating inside the MMA drifts (its adds are
// not round-to-nearest), which a bf16 rounding of the next conv's input would amplify.
__device__ __forceinline__ void mma_bf16(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  float d0, d1, d2, d3;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
  acc[0] = __fadd_rn(acc[0], d0);
  acc[1] = __fadd_rn(acc[1], d1);
  acc[2] = __fadd_rn(acc[2], d2);
  acc[3] = __fadd_rn(acc[3], d3);
}

// y2[clamp(n)] from x clamped to [0, T).
template <typename TX>
__device__ __forceinline__ float y2_at(const TX* xrow, int T, int n) {
  n = aa::clampi(n, 0, 2 * T - 1);
  const int v = n >> 1, par = n & 1;
  float y = 0.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j)
    y = aa::add(y, aa::mul(aa::kFilt[11 - 2 * j - par], aa::ld(xrow, aa::clampi(v - 3 + par + j, 0, T - 1))));
  return aa::mul(2.0f, y);
}

// One run of activation values, col[r * lda] = bf16(aa_snake(x)[pb + r]) for r < len.  Pair m
// holds the snake values at 2x-rate indices 2 pb - 5 + 2m (e) and 2 pb - 4 + 2m (o),
// aa_snake.cuh's ss; value r is the decimating FIR over pairs r .. r + 5.  Pair m sits in slot
// m % 6 and xw[(m + j) % 6] = x[pb - 5 + m + j]: with the loops unrolled by six the windows rotate
// by index, not by moves, and six pairs and six x values are live.  A run near a sequence edge
// (kEdge) clamps its x reads to [0, T), takes y2[0] or y2[2T - 1] for 2x-rate indices past the
// ends, and writes 0 for positions outside [0, T): the same arithmetic as inside, a few
// selects more.
template <typename TX, bool kEdge>
struct Run {
  const TX* x;
  __nv_bfloat16* col;
  int pb, lda, T;
  aa::SnakeAB ab;
  float y2_lo, y2_hi;
  float xw[6], e[6], o[6];

  __device__ __forceinline__ float x_at(int q) const { return aa::ld(x, kEdge ? aa::clampi(q, 0, T - 1) : q); }
  __device__ __forceinline__ float y2_edge(float y, int n) const {
    return n < 0 ? y2_lo : (n > 2 * T - 1 ? y2_hi : y);
  }
  __device__ __forceinline__ void start() {  // x for pair 0, then pairs 0 .. 4
    if (kEdge) {
      y2_lo = y2_at(x, T, 0);
      y2_hi = y2_at(x, T, 2 * T - 1);
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) xw[j] = x_at(pb - 5 + j);
#pragma unroll
    for (int m = 0; m < 5; ++m) pair(m, m);
  }
  __device__ __forceinline__ void pair(int m, int slot) {
    xw[(slot + 5) % 6] = x_at(pb + m);
    float yo = 0.0f, ye = 0.0f;  // y2 at the odd index 2 pb - 5 + 2m and the even one after it
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      yo = aa::add(yo, aa::mul(aa::kFilt[10 - 2 * j], xw[(slot + j) % 6]));
      ye = aa::add(ye, aa::mul(aa::kFilt[11 - 2 * j], xw[(slot + j) % 6]));
    }
    yo = aa::mul(2.0f, yo);
    ye = aa::mul(2.0f, ye);
    if (kEdge) {
      yo = y2_edge(yo, 2 * pb - 5 + 2 * m);
      ye = y2_edge(ye, 2 * pb - 4 + 2 * m);
    }
    e[slot] = aa::snake(yo, ab.alpha, ab.inv_beta);
    o[slot] = aa::snake(ye, ab.alpha, ab.inv_beta);
  }
  __device__ __forceinline__ void step(int m, int slot) {  // pair m, then value m - 5
    pair(m, slot);
    float z = 0.0f;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const int k = (slot + 1 + a) % 6;
      z = aa::add(z, aa::add(aa::mul(aa::kFilt[2 * a], e[k]), aa::mul(aa::kFilt[2 * a + 1], o[k])));
    }
    if (kEdge && (pb + m - 5 < 0 || pb + m - 5 >= T)) z = 0.0f;
    col[(m - 5) * lda] = __float2bfloat16(z);
  }
  __device__ __forceinline__ void rows(int len) {
    start();
    int m0 = 5;  // m0 % 6 == 5 in every group: pair m0 + u sits in slot (u + 5) % 6
    for (; m0 + 6 <= len + 5; m0 += 6) {  // no exit inside a group, so its pairs interleave
#pragma unroll
      for (int u = 0; u < 6; ++u) step(m0 + u, (u + 5) % 6);
    }
#pragma unroll
    for (int u = 0; u < 5; ++u)
      if (m0 + u < len + 5) step(m0 + u, (u + 5) % 6);
  }
};

// col[r * lda] = bf16(aa_snake(x)[pb + r]) for r < len, 0 where pb + r lies outside [0, T).
template <typename TX>
__device__ __forceinline__ void act_rows(const TX* xrow, int T, int pb, int len, aa::SnakeAB ab, __nv_bfloat16* col,
                                         int lda) {
  if (pb >= 5 && pb + len + 4 <= T - 1) {
    Run<TX, false>{xrow, col, pb, lda, T, ab}.rows(len);
  } else {
    Run<TX, true>{xrow, col, pb, lda, T, ab}.rows(len);
  }
}

__device__ __forceinline__ float4 ld4(const void* p, int dtype, int64_t i) {
  if (dtype == aa::BF16) {
    const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
}

__device__ __forceinline__ void st4(void* p, int dtype, int64_t i, float4 v) {
  if (dtype == aa::BF16) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) = u;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = v;
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

struct CallArgs {
  const void* x;
  int x_dtype, T;
  const void* res;
  int res_dtype;
  float* out;
  const float* acc_in;
  float* acc_out;
  void* fin;
  int fin_dtype;
};

template <class Cf>
__global__ void __launch_bounds__(kThreads, 2) amp_conv_mma_kernel(AmpConvParams p, CallArgs c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.C, K = p.K, dil = p.dil, T = c.T;
  const Geometry g = geometry<Cf>(C, K, dil);
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + g.act_bytes);

  const int t0 = blockIdx.x * Cf::kTime;
  const int64_t b = blockIdx.y;
  const int p0 = t0 - dil * (K - 1) / 2;  // activation position of act row 0
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);

  // Weight chunk q = (tap j, channels i0 .. i0 + kc) -> ring slot q % kRing.
  const int per_tap = C / g.kc, n_chunks = K * per_tap, pieces = g.kc / 8;
  auto load_chunk = [&](int q) {
    const int j = q / per_tap, i0 = (q - j * per_tap) * g.kc;
    const __nv_bfloat16* src = w + static_cast<int64_t>(j) * C * C + i0;
    __nv_bfloat16* dst = ring + (q % kRing) * Cf::kCout * g.ldb;
    for (int idx = threadIdx.x; idx < C * pieces; idx += kThreads) {
      const int o = idx / pieces, pc = idx - o * pieces;
      cp_async16(dst + o * g.ldb + pc * 8, src + static_cast<int64_t>(o) * C + pc * 8);
    }
  };
#pragma unroll
  for (int q = 0; q < kRing - 1; ++q) {
    if (q < n_chunks) load_chunk(q);
    cp_async_commit();
  }

  // Prologue: act[s][i] = bf16(aa_snake(x)[b, i, p0 + s]), 0 outside [0, T).  Each thread takes
  // one channel and an equal share of its W rows; neighbouring threads take neighbouring channels.
  const int n_seg = C >= kThreads ? 1 : kThreads / C;
  const int seg_len = (g.W + n_seg - 1) / n_seg;
  if (threadIdx.x < C * n_seg) {
    const int ch = threadIdx.x % C, s0 = (threadIdx.x / C) * seg_len;
    const int len = min(seg_len, g.W - s0);
    if (len > 0) {
      const aa::SnakeAB ab = aa::snake_ab(p.alpha, p.beta, aa::BF16, p.logscale, ch);
      const int64_t row = (b * C + ch) * T;
      __nv_bfloat16* col = act + s0 * g.lda + ch;
      if (c.x_dtype == aa::BF16)
        act_rows(static_cast<const __nv_bfloat16*>(c.x) + row, T, p0 + s0, len, ab, col, g.lda);
      else
        act_rows(static_cast<const float*>(c.x) + row, T, p0 + s0, len, ab, col, g.lda);
    }
  }

  // Main loop over the weight chunks.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m_base = (warp / Cf::WN) * Cf::MT * 16;
  const int n_base = (warp % Cf::WN) * Cf::NT * 8;
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;
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
    const __nv_bfloat16* arow = act + (m_base + a_row + j * dil) * g.lda + i0 + a_col;
    const __nv_bfloat16* brow = ring + (q % kRing) * Cf::kCout * g.ldb + (n_base + b_row) * g.ldb + b_col;
    for (int kk = 0; kk < g.kc; kk += 16) {
      uint32_t af[Cf::MT][4];
#pragma unroll
      for (int mt = 0; mt < Cf::MT; ++mt) ldsm_x4(af[mt], arow + mt * 16 * g.lda + kk);
#pragma unroll
      for (int np = 0; np < Cf::NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, brow + np * 16 * g.ldb + kk);
#pragma unroll
        for (int mt = 0; mt < Cf::MT; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
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
      if (o < C) {  // columns past C (C not a multiple of the warp grid) hold nothing
        eb[o * lde + t] = acc[mt][nt][0];
        eb[(o + 1) * lde + t] = acc[mt][nt][1];
        eb[o * lde + t + 8] = acc[mt][nt][2];
        eb[(o + 1) * lde + t + 8] = acc[mt][nt][3];
      }
    }
  __syncthreads();
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.bias);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(c.res) | reinterpret_cast<uintptr_t>(c.out) |
                         reinterpret_cast<uintptr_t>(c.acc_in) | reinterpret_cast<uintptr_t>(c.acc_out) |
                         reinterpret_cast<uintptr_t>(c.fin);
  if (T % 4 == 0 && ptrs % 16 == 0) {  // four times a thread, 16-byte fp32 accesses
    constexpr int kQuads = Cf::kTime / 4;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < C * kQuads; idx += kThreads) {
      const int o = idx / kQuads, r = (idx % kQuads) * 4;
      if (t0 + r >= T) continue;
      const int64_t gi = (b * C + o) * T + t0 + r;
      const float bo = aa::ld(bias, o);
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
  for (int idx = threadIdx.x; idx < C * Cf::kTime; idx += kThreads) {
    const int o = idx / Cf::kTime, r = idx % Cf::kTime;
    const int t = t0 + r;
    if (t >= T) continue;
    const int64_t gi = (b * C + o) * T + t;
    float v = eb[o * lde + r] + aa::ld(bias, o);
    if (c.res) v += aa::ld_any(c.res, c.res_dtype, gi);
    if (c.out) c.out[gi] = v;
    if (c.acc_out || c.fin) {
      const float s = (c.acc_in ? c.acc_in[gi] : 0.0f) + v;
      if (c.fin) aa::st_any(c.fin, c.fin_dtype, gi, s / p.n_blocks);
      else c.acc_out[gi] = s;
    }
  }
}

constexpr int kMaxDevices = 64;

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

template <class Cf>
cudaError_t launch(const AmpConvParams& p, const CallArgs& c, int B, cudaStream_t stream) {
  const Geometry g = geometry<Cf>(p.C, p.K, p.dil);
  auto kernel = amp_conv_mma_kernel<Cf>;
  // The dynamic shared-memory cap (a cap, not a reservation) is raised only when a launch needs more.
  static int cap[kMaxDevices] = {};
  const int dev = current_device();
  const int need = static_cast<int>(g.smem_bytes);
  if (dev >= kMaxDevices || need > cap[dev]) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) cap[dev] = need;
  }
  dim3 grid((c.T + Cf::kTime - 1) / Cf::kTime, B);
  kernel<<<grid, kThreads, g.smem_bytes, stream>>>(p, c);
  return cudaGetLastError();
}

// The (large, small) tile configurations of each channel class.
template <class F>
auto with_configs(int C, F&& f) {
  if (C <= 16) return f(Cfg<8, 1, 2, 2, false>{}, Cfg<8, 1, 1, 2, true>{});
  if (C <= 32) return f(Cfg<8, 1, 2, 4, false>{}, Cfg<8, 1, 1, 4, true>{});
  if (C <= 64) return f(Cfg<8, 1, 2, 8, false>{}, Cfg<8, 1, 1, 8, true>{});
  if (C <= 128) return f(Cfg<4, 2, 2, 8, false>{}, Cfg<4, 2, 1, 8, true>{});
  return f(Cfg<2, 4, 2, 8, false>{}, Cfg<1, 8, 1, 4, true>{});
}

// The small tile when the large one leaves the grid under two blocks per SM.
bool small_grid(int B, int T, int big_time) {
  static int sm_count[kMaxDevices] = {};
  const int dev = current_device();
  int sms = dev < kMaxDevices ? sm_count[dev] : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (dev < kMaxDevices) sm_count[dev] = sms;
  }
  return static_cast<int64_t>(B) * ((T + big_time - 1) / big_time) < 2 * static_cast<int64_t>(sms);
}

cudaError_t dispatch(const AmpConvParams& p, const CallArgs& c, int B, cudaStream_t s) {
  return with_configs(p.C, [&](auto big, auto small) -> cudaError_t {
    using Big = decltype(big);
    using Small = decltype(small);
    return small_grid(B, c.T, Big::kTime) ? launch<Small>(p, c, B, s) : launch<Big>(p, c, B, s);
  });
}

}  // namespace

// One conv of an AMP chain (amp_conv.cuh): bf16 parameters with w packed as
// (K, C, C), x in bf16 or fp32.  C must be a multiple of 16 and at most 256, K odd.
extern "C" int amp_conv_fwd(const AmpConvParams* p, const void* x, int x_dtype, int B, int T, const void* res,
                            int res_dtype, float* out, const float* acc_in, float* acc_out, void* fin, int fin_dtype,
                            void* stream) {
  if (p->param_dtype != aa::BF16 || (x_dtype != aa::BF16 && x_dtype != aa::F32) || B <= 0 || B > 65535 ||
      p->C <= 0 || p->C % 16 != 0 || p->C > 256 || T <= 0 || p->K <= 0 || p->K % 2 == 0 || p->dil <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const CallArgs c{x, x_dtype, T, res, res_dtype, out, acc_in, acc_out, fin, fin_dtype};
  return static_cast<int>(dispatch(*p, c, B, static_cast<cudaStream_t>(stream)));
}

// The time tile a launch at (C, B, T) takes, so a caller can count its blocks: B * ceil(T / tile).
extern "C" int amp_conv_time_tile(int C, int B, int T) {
  if (C <= 0 || C % 16 != 0 || C > 256 || B <= 0 || T <= 0) return 0;
  return with_configs(C, [&](auto big, auto small) -> int {
    using Big = decltype(big);
    using Small = decltype(small);
    return small_grid(B, T, Big::kTime) ? Small::kTime : Big::kTime;
  });
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
