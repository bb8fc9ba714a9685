// K1: the anti-aliased Snake activation, one pass over device memory.
//
// Replaces the Pallas kernel vocoder_tpu/ops/pallas/aa_snake.py::_kernel
// (pallas_call in _interior), which BigVGAN runs as its anti-aliased Snake.
// Here it serves `activation_post` (C = 16, T = 512 F at 44.1 kHz); the AMP
// conv kernel (amp_conv_mma.cu) runs the same aa::Run as its prologue.
//
// Bound on an H100: per output sample it reads one input and writes one
// output (4 or 8 bytes in bf16 or fp32) and does 88 fp32 operations in its
// FMA form (two 6-tap branch FIRs, two snakes with the Cody-Waite sin
// polynomial, one 12-tap FIR; ops/aa_snake.py counts them), so in bf16 at
// 67 TFLOP/s against 3.35 TB/s the CUDA cores, not the memory, set the bound,
// and the design is about instructions per output:
// - Each thread computes a run of kRun consecutive outputs of one row in
//   registers (aa::Run, aa_snake.cuh): one x read, two snakes and one
//   decimating FIR an output, plus five snake pairs to start; no 2x-rate
//   intermediate in shared memory and no barrier between the three steps.
// - The arithmetic is aa::Fma: FIR taps, range reduction and polynomial as
//   FMAs, about half the instructions of the plain version's operations.
//   K1's output goes to a conv as it is, so it need not match the plain
//   version to the bit (K2's prologue does, and keeps aa::Exact).
// - x reaches the runs from shared memory: one bulk copy (cp.async.bulk on an
//   mbarrier) per block of its tile and an 8-sample halo each side.  kRun is
//   odd, so a warp's 32 runs read (and write their staged outputs to) 32
//   banks.  (Reading x from device memory instead, where a warp's load
//   touches 32 cache lines, is slower: PERF.md, tools/k1_variants.py.)  A
//   tile whose halo leaves [0, T), or whose row is not 16-byte aligned, is
//   filled by clamped loads instead, and only its runs at a sequence end take
//   the clamped path (aa::Run's kEdge).
// - A row of a padded batch has its own length L <= T (`lens`, per item): L
//   takes T's place in every clamp, outputs at or past L are 0, a tile that
//   starts at or past L writes its zeros and reads nothing, and only a tile
//   whose staged window lies inside [0, L) takes the bulk copy (elsewhere the
//   clamp must replicate x[L - 1] where the copy would stage padding).
// - The outputs are staged in shared memory as fp32 and leave in 16-byte
//   stores along the row, in x's dtype.
// - The grid is 1-D over (row, tile), so any B * C fits; a 3968-output tile
//   gives 33 full blocks a row at activation_post's T = 131072, which at b1
//   (16 rows) is 4 a streaming multiprocessor, one wave.
// Layout (B, C, T) contiguous; alpha/beta are the raw (C,) parameters.

#include "aa_snake.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 31;                 // outputs a thread; odd, for the shared-memory banks
constexpr int kTile = kThreads * kRun;   // outputs a block
constexpr int kHalo = 8;                 // x samples staged each side: 5 needed, 8 keep 16-byte alignment
using Arith = aa::Fma;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x staged in shared memory: at(q) = x[clamp(q)] for q in [base, base + kTile + 2 kHalo).
template <typename TX>
struct SharedX {
  const TX* xs;
  int base;
  const TX* row;  // the row in device memory, for the runs at a sequence end
  __device__ __forceinline__ float at(int q) const { return aa::ld(xs, q - base); }
};

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

struct StagedOut {
  float* o;
  __device__ __forceinline__ void put(int r, float v) const { o[r] = v; }
};

template <typename TX>
__global__ void __launch_bounds__(kThreads)
aa_snake_kernel(const TX* __restrict__ x, TX* __restrict__ z, const void* alpha, const void* beta, int pdtype,
                int logscale, int C, int T, int tiles, int bulk_ok, const int* __restrict__ lens) {
  __shared__ __align__(16) float outs[kTile];
  __shared__ __align__(16) TX xs[kTile + 2 * kHalo];
  __shared__ __align__(8) uint64_t bar;
  __shared__ Arith::Params ab_s;

  const int64_t row = blockIdx.x / tiles;  // b * C + c
  const int p0 = (blockIdx.x - row * tiles) * kTile;
  const int W = min(kTile, T - p0);
  const int L = lens ? aa::clampi(lens[row / C], 0, T) : T;  // the row's length
  if (p0 >= L) {  // the tile lies in the row's padding
    for (int i = threadIdx.x; i < W; i += kThreads) aa::st(z + row * T + p0, i, 0.0f);
    return;
  }
  const TX* xrow = x + row * T;
  const int s0 = threadIdx.x * kRun, len = min(kRun, W - s0);

  const bool bulk = bulk_ok && p0 >= kHalo && p0 + kTile + kHalo <= L;
  if (threadIdx.x == 0) {
    ab_s = Arith::params(alpha, beta, pdtype, logscale, static_cast<int>(row % C));
    if (bulk) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  if (!bulk)  // clamped loads: xs[i] = x[clamp(p0 - kHalo + i, 0, L - 1)]
    for (int i = threadIdx.x; i < W + 2 * kHalo; i += kThreads) xs[i] = xrow[aa::clampi(p0 - kHalo + i, 0, L - 1)];
  __syncthreads();
  if (bulk) {
    constexpr uint32_t bytes = (kTile + 2 * kHalo) * sizeof(TX);
    const uint32_t b = smem_addr(&bar);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                   ::"r"(smem_addr(xs)), "l"(xrow + p0 - kHalo), "r"(bytes), "r"(b)
                   : "memory");
    }
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(b)
          : "memory");
    }
  }

  const int pb = p0 + s0;
  const int n = min(len, L - pb);  // the run's outputs before L; the rest are 0
  if (n > 0) {
    const Arith::Params ab = ab_s;
    const SharedX<TX> src{xs, p0 - kHalo, xrow};
    if (!aa::run_at_edge(pb, n, L)) {
      aa::Run<Arith, SharedX<TX>, StagedOut, false>{src, {outs + s0}, pb, L, ab}.rows(n);
    } else {
      aa::Run<Arith, SharedX<TX>, StagedOut, true>{src, {outs + s0}, pb, L, ab}.rows(n);
    }
  }
  for (int r = max(n, 0); r < len; ++r) outs[s0 + r] = 0.0f;
  __syncthreads();

  // outs -> z along the row, 16 bytes a thread where the row segment is aligned.
  TX* zrow = z + row * T + p0;
  constexpr int V = 16 / sizeof(TX);
  int done_to = 0;
  if (reinterpret_cast<uintptr_t>(zrow) % 16 == 0) {
    done_to = W / V * V;
    for (int i = threadIdx.x * V; i < done_to; i += kThreads * V) {
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(zrow + i) = *reinterpret_cast<const float4*>(outs + i);
      } else {
        const float4 a = *reinterpret_cast<const float4*>(outs + i);
        const float4 c = *reinterpret_cast<const float4*>(outs + i + 4);
        *reinterpret_cast<uint4*>(zrow + i) = make_uint4(bf16x2(a.x, a.y), bf16x2(a.z, a.w), bf16x2(c.x, c.y),
                                                         bf16x2(c.z, c.w));
      }
    }
  }
  for (int i = done_to + threadIdx.x; i < W; i += kThreads) aa::st(zrow, i, outs[i]);
}

}  // namespace

// x, z: (B, C, T) of dtype x_dtype (0 fp32, 1 bf16); alpha/beta: (C,) of
// p_dtype; lens: the device int32 (B,) length of each item, clamped to [0, T],
// or nullptr for every row T long.  Returns cudaGetLastError() after the launch.
extern "C" int aa_snake_fwd(const void* x, void* z, int x_dtype, const void* alpha, const void* beta, int p_dtype,
                            int logscale, int B, int C, int T, const int* lens, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (T + kTile - 1) / kTile;
  const int64_t blocks = static_cast<int64_t>(B) * C * tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t esize = x_dtype == aa::BF16 ? 2 : 4;
  const int bulk_ok = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (static_cast<size_t>(T) * esize) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == aa::BF16) {
    aa_snake_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(z), alpha, beta, p_dtype, logscale, C, T,
        static_cast<int>(tiles), bulk_ok, lens);
  } else {
    aa_snake_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(z), alpha, beta, p_dtype, logscale, C, T,
        static_cast<int>(tiles), bulk_ok, lens);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
