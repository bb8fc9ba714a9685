// The backward of K1, the anti-aliased Snake: (dx, d alpha, d beta) in one pass over x and gz.
//
// Replaces no Pallas kernel: the JAX package's backward of fused_aa_snake is XLA
// (vocoder_tpu/ops/antialias.py:312).  On the card it takes the place of the plain
// PyTorch VJP (ops/antialias.py::aa_snake_plain_vjp), which issues ~165 launches a call,
// each a pass over fp32 tensors on the upsampled 2T grid; BigVGAN's training step makes
// 91 calls.  It computes the same function (aa_snake.cuh gives the forward; f is the
// 12-tap filter, v the 1x-rate index, y2 the upsampled pre-activation):
//
//   G(n)    = sum_t f[n + 5 - 2t] gz[t]       the decimating FIR's adjoint at y2 index n:
//             G(2v) = sum_i f[11 - 2i] gz[v - 3 + i],  G(2v + 1) = sum_i f[10 - 2i] gz[v - 2 + i]
//   dv[n]   = G(n), plus G(-5 .. -1) at n = 0 and G(2T .. 2T + 5) at n = 2T - 1 (the clamped edges)
//   dy2[n]  = dv[n] (1 + alpha sin(u) / (beta + 1e-9)),  u = 2 alpha y2[n]
//   d alpha = sum dv y2 sin(u) / (beta + 1e-9),  d beta = -sum dv (1 - cos u) / 2 / (beta + 1e-9)^2
//   dx[q]   = sum_j 2 f[11 - 2j] dy2[2(q + 3 - j)] + 2 f[10 - 2j] dy2[2(q + 2 - j) + 1], plus the
//             terms of q = -3 .. -1 at dx[0] and of q = T .. T + 2 at dx[T - 1] (the clamped edges)
//
// Bound on an H100: it reads x and gz and writes dx once, 12 bytes a sample in fp32 (6 in
// bf16), and does BWD_FLOPS_PER_SAMPLE fp32 operations a sample (ops/aa_snake.py counts them),
// so fp32 is bound by the memory and bf16 by the CUDA cores.  The design keeps every
// intermediate on the 2T grid out of device memory:
// - A block owns one (b, c) row and a tile of kTile = kThreads * kRun - 6 outputs.  It stages
//   x (clamped to the row) and gz (zero outside it) as fp32 over the tile and a 6-sample halo
//   each side in shared memory, by coalesced loads: one path for every tile, edges included.
// - Each thread takes a run of kRun consecutive v (odd, so a warp's runs fall in 32 banks) and
//   forms y2 and G at both parities from windows of x and gz in registers, then dy2, from one
//   Cody-Waite reduction of u that gives sin(u) and 1 - cos(u) (the polynomials of the plain
//   version, ops/antialias.py).  The tile's dy2 and its 3-sample halo each side go to shared
//   memory; the runs then apply the upsampling FIR's adjoint from windows of dy2 in registers,
//   and dx leaves through shared memory along the row.
// - The clamped edges fold in the blocks that own them: dv[0] and dv[2T - 1] take the snake
//   outputs past the ends (G of those indices, from gz in device memory), dx[0] and dx[T - 1]
//   the x samples past them.  No atomics: each sample of dx has one writer.
// - d alpha and d beta: each block sums its own v (each v has one owner) into one fp32 pair;
//   a second kernel of one block a channel sums the pairs in a fixed order and scales them.
//   The result is the same in every run.
// Layout (B, C, T) contiguous; alpha/beta are the (C,) parameters as the snake uses them
// (already exp'ed).

#include "aa_snake.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 5;                        // consecutive v a thread; odd, for the shared-memory banks
constexpr int kSpan = kThreads * kRun;         // v of a block: its tile and 3 each side
constexpr int kTile = kSpan - 6;               // dx outputs a block
constexpr int kStage = kSpan + 6;              // x, gz staged from q0 - 6; dy2 stored from v = q0 - 3

// G(n) from gz in device memory, zero outside [0, T): the edge folds only.
template <typename TX>
__device__ float g_at(const TX* grow, int T, int n) {
  float s = 0.0f;
#pragma unroll
  for (int m = 0; m < 12; ++m) {
    const int d = n + 5 - m;
    if (d >= 0 && (d & 1) == 0 && (d >> 1) < T) s = __fmaf_rn(aa::kFilt[m], aa::ld(grow, d >> 1), s);
  }
  return s;
}

struct Params {
  float alpha2, aib;  // 2 alpha, alpha / (beta + 1e-9)
};

// dy2 from y2 and dv; adds dv y2 sin(u) to pa and dv (1 - cos u) to pb where `own`.
__device__ __forceinline__ float dsnake(float y, float dv, const Params& p, bool own, float& pa, float& pb) {
  constexpr float kShift = 12582912.0f;                 // 1.5 * 2^23: round to nearest for |u| / 2 pi < 2^22
  constexpr float kTwoPiHi = 6.28318548202514648f;      // fp32(2 pi)
  constexpr float kTwoPiLo = -1.7484555314695172e-07f;  // 2 pi - kTwoPiHi
  constexpr float kCos[7] = {AA_COS};
  // sin(r) = r sum_i kSin[i] r^(2i) on [-pi, pi]: the plain version's polynomial (ops/antialias.py _SIN_COEF).
  constexpr float kSin[7] = {0.9999999994768398f,     -0.16666666108562112f,   0.008333323685091395f,
                             -0.0001984064754254522f, 2.7538258044539417e-06f, -2.4752169156660884e-08f,
                             1.3697464704976747e-10f};
  const float u = __fmul_rn(y, p.alpha2);
  const float k = __fsub_rn(__fmaf_rn(u, 0.15915494309189535f, kShift), kShift);
  const float r = __fmaf_rn(-k, kTwoPiLo, __fmaf_rn(-k, kTwoPiHi, u));
  const float r2 = __fmul_rn(r, r);
  float s = kSin[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) s = __fmaf_rn(s, r2, kSin[i]);
  s = __fmul_rn(s, r);  // sin(u)
  float c = -kCos[6];   // 1 - cos(u) = -r2 sum_{i >= 1} kCos[i] r2^(i - 1); kCos[0] is 1 in fp32
#pragma unroll
  for (int i = 5; i >= 1; --i) c = __fmaf_rn(c, r2, -kCos[i]);
  c = __fmul_rn(c, r2);
  if (own) {
    pa = __fmaf_rn(__fmul_rn(dv, y), s, pa);
    pb = __fmaf_rn(dv, c, pb);
  }
  return __fmaf_rn(__fmul_rn(dv, p.aib), s, dv);
}

// The upsampling FIR's adjoint at q from the stored dy2 (index v - q0 + 3), terms with v outside
// [0, T) left out: the edge folds only.
__device__ float dxp_at(const float* dye, const float* dyo, int q0, int T, int q) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int ve = q + 3 - j, vo = q + 2 - j;
    if (ve >= 0 && ve < T) s = __fmaf_rn(aa::kFilt2[11 - 2 * j], dye[ve - q0 + 3], s);
    if (vo >= 0 && vo < T) s = __fmaf_rn(aa::kFilt2[10 - 2 * j], dyo[vo - q0 + 3], s);
  }
  return s;
}

__device__ __forceinline__ void block_sum2(float& a, float& b, float (*red)[kThreads / 32]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = a;
    red[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = b = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
  }
}

template <typename TX>
__global__ void __launch_bounds__(kThreads)
aa_snake_bwd_kernel(const TX* __restrict__ x, const TX* __restrict__ gz, TX* __restrict__ dx, const void* alpha,
                    const void* beta, int pdtype, int C, int T, int tiles, float* __restrict__ partial) {
  __shared__ float xs[kStage];  // x[clamp(q0 - 6 + i)]; then dx of the tile
  __shared__ float gs[kStage];  // gz[q0 - 6 + i], 0 outside [0, T)
  __shared__ float dye[kStage], dyo[kStage];  // dy2 at 2v and 2v + 1, v = q0 - 3 + i
  __shared__ float red[2][kThreads / 32];

  const int64_t row = blockIdx.x / tiles;  // b * C + c
  const int q0 = static_cast<int>(blockIdx.x - row * tiles) * kTile;
  const int W = min(kTile, T - q0);
  const TX* xrow = x + row * T;
  const TX* grow = gz + row * T;
  for (int i = threadIdx.x; i < kStage; i += kThreads) {
    const int q = q0 - 6 + i;
    xs[i] = aa::ld(xrow, aa::clampi(q, 0, T - 1));
    gs[i] = q >= 0 && q < T ? aa::ld(grow, q) : 0.0f;
  }
  const float2 ab = aa::snake_params(alpha, beta, pdtype, 0, static_cast<int>(row % C));
  const Params p{2.0f * ab.x, ab.x * (1.0f / (ab.y + 1e-9f))};  // the plain version's a * inv_b
  __syncthreads();

  // dy2 over v = q0 - 3 + s .. + kRun; x[v - 3 + i] = xw[k + i] and gz likewise, for the run's k-th v.
  const int s = threadIdx.x * kRun;
  float pa = 0.0f, pb = 0.0f;
  {
    float xw[kRun + 6], gw[kRun + 6];
#pragma unroll
    for (int i = 0; i < kRun + 6; ++i) {
      xw[i] = xs[s + i];
      gw[i] = gs[s + i];
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int v = q0 - 3 + s + k;
      float ye = __fmul_rn(aa::kFilt2[11], xw[k]), yo = __fmul_rn(aa::kFilt2[10], xw[k + 1]);
      float ge = __fmul_rn(aa::kFilt[11], gw[k]), go = __fmul_rn(aa::kFilt[10], gw[k + 1]);
#pragma unroll
      for (int i = 1; i < 6; ++i) {
        ye = __fmaf_rn(aa::kFilt2[11 - 2 * i], xw[k + i], ye);
        yo = __fmaf_rn(aa::kFilt2[10 - 2 * i], xw[k + 1 + i], yo);
        ge = __fmaf_rn(aa::kFilt[11 - 2 * i], gw[k + i], ge);
        go = __fmaf_rn(aa::kFilt[10 - 2 * i], gw[k + 1 + i], go);
      }
      float de = 0.0f, dn = 0.0f;
      if (v >= 0 && v < T) {
        if (v == 0)
          for (int n = -5; n < 0; ++n) ge += g_at(grow, T, n);
        if (v == T - 1)
          for (int n = 2 * T; n < 2 * T + 6; ++n) go += g_at(grow, T, n);
        const bool own = s + k >= 3 && s + k < 3 + W;
        de = dsnake(ye, ge, p, own, pa, pb);
        dn = dsnake(yo, go, p, own, pa, pb);
      }
      dye[s + k] = de;
      dyo[s + k] = dn;
    }
  }
  __syncthreads();

  // dx[q0 + s + k] = sum_j 2 f[11 - 2j] dy2e[v = q + 3 - j] + 2 f[10 - 2j] dy2o[v = q + 2 - j]: ew[i] holds
  // dy2e at stored index s + 1 + i, ow[i] dy2o at s + i.
  const int len = min(kRun, W - s);
  if (len > 0) {
    float ew[kRun + 5], ow[kRun + 5];
#pragma unroll
    for (int i = 0; i < kRun + 5; ++i) {
      ew[i] = dye[s + 1 + i];
      ow[i] = dyo[s + i];
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (k < len) {
        float d = __fmul_rn(aa::kFilt2[11], ew[k + 5]);
        d = __fmaf_rn(aa::kFilt2[10], ow[k + 5], d);
#pragma unroll
        for (int j = 1; j < 6; ++j) {
          d = __fmaf_rn(aa::kFilt2[11 - 2 * j], ew[k + 5 - j], d);
          d = __fmaf_rn(aa::kFilt2[10 - 2 * j], ow[k + 5 - j], d);
        }
        const int q = q0 + s + k;
        if (q == 0)
          for (int e = -3; e < 0; ++e) d += dxp_at(dye, dyo, q0, T, e);
        if (q == T - 1)
          for (int e = T; e < T + 3; ++e) d += dxp_at(dye, dyo, q0, T, e);
        xs[s + k] = d;  // xs is no longer read: every run read its window before the barrier above
      }
    }
  }
  block_sum2(pa, pb, red);  // its barrier also orders the stores to xs before the loop below
  if (threadIdx.x == 0) {
    partial[2 * static_cast<int64_t>(blockIdx.x)] = pa;
    partial[2 * static_cast<int64_t>(blockIdx.x) + 1] = pb;
  }
  TX* dxrow = dx + row * T + q0;
  for (int i = threadIdx.x; i < W; i += kThreads) aa::st(dxrow, i, xs[i]);
}

// d alpha[c] and d beta[c]: the pairs of channel c's blocks, b-major then tile, summed in a fixed order.
__global__ void __launch_bounds__(kThreads)
aa_snake_bwd_params_kernel(const float* __restrict__ partial, void* dalpha, void* dbeta, const void* alpha,
                           const void* beta, int pdtype, int B, int C, int tiles) {
  __shared__ float red[2][kThreads / 32];
  const int c = blockIdx.x;
  const int n = B * tiles;
  float sa = 0.0f, sb = 0.0f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int b = j / tiles;
    const int64_t blk = (static_cast<int64_t>(b) * C + c) * tiles + (j - b * tiles);
    sa += partial[2 * blk];
    sb += partial[2 * blk + 1];
  }
  block_sum2(sa, sb, red);
  if (threadIdx.x == 0) {
    const float2 ab = aa::snake_params(alpha, beta, pdtype, 0, c);
    const float ib = 1.0f / (ab.y + 1e-9f);
    aa::st_any(dalpha, pdtype, c, ib * sa);
    aa::st_any(dbeta, pdtype, c, -(ib * ib) * (0.5f * sb));
  }
}

int64_t tiles_of(int T) { return (static_cast<int64_t>(T) + kTile - 1) / kTile; }

}  // namespace

// fp32 words of the scratch `aa_snake_bwd` takes: one (d alpha, d beta) pair a block.
extern "C" long long aa_snake_bwd_scratch(int B, int C, int T) {
  return 2LL * B * C * (T > 0 ? tiles_of(T) : 0);
}

// x, gz, dx: (B, C, T) of dtype x_dtype (0 fp32, 1 bf16); alpha/beta, dalpha/dbeta: (C,) of p_dtype, the
// parameters as the snake uses them; scratch: aa_snake_bwd_scratch(B, C, T) fp32 words.  Two launches on
// `stream`; returns cudaGetLastError() after them.
extern "C" int aa_snake_bwd(const void* x, const void* gz, void* dx, int x_dtype, const void* alpha, const void* beta,
                            void* dalpha, void* dbeta, int p_dtype, int B, int C, int T, float* scratch,
                            void* stream) {
  if (B <= 0 || C <= 0 || T <= 0 || T > (1 << 29)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = tiles_of(T);
  const int64_t blocks = static_cast<int64_t>(B) * C * tiles;
  if (blocks > 0x7fffffff || static_cast<int64_t>(B) * tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == aa::BF16) {
    aa_snake_bwd_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gz), static_cast<__nv_bfloat16*>(dx),
        alpha, beta, p_dtype, C, T, static_cast<int>(tiles), scratch);
  } else {
    aa_snake_bwd_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gz), static_cast<float*>(dx), alpha, beta, p_dtype, C,
        T, static_cast<int>(tiles), scratch);
  }
  aa_snake_bwd_params_kernel<<<C, kThreads, 0, s>>>(scratch, dalpha, dbeta, alpha, beta, p_dtype, B, C,
                                                    static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
