// K2, fp32 route: one conv of a BigVGAN AMP stage with its anti-aliased Snake fused in.
//
// Replaces the Pallas kernel vocoder_tpu/ops/pallas/amp_block.py::_kernel
// (pallas_call in amp_stage_fused).  That kernel runs a whole AMP stage per
// time tile out of 100 MiB of TPU VMEM; a Hopper block has 227 KB of shared
// memory, less than one C=128, k=11 conv weight in bf16, and a block chain's
// receptive field is +-90 samples.  So this kernel is one conv of the chain:
//
//   out[b, o, t] = bias[o] + sum_{i, j} w[o, i, j] * a[b, i, t + j*dil - pad]
//   a = aa_snake(x) on [0, T), 0 outside (the conv zero-pads the activation)
//
// with epilogues for the residual add (second conv of a pair) and for the
// running sum over the stage's blocks (last conv of a block), which also
// divides by the block count and casts on the stage's last conv (the
// interface is amp_conv.cuh's).  A stage is 18 launches; ops/amp_block.py
// drives them and keeps the residual stream and the stage sum in fp32
// between launches, as the TPU kernel kept them in fp32 in VMEM.
//
// Bound on an H100: 2 C K operations per output and channel against a few
// bytes per sample, so the arithmetic sets it: 67 TFLOP/s on the CUDA
// cores, 989 TFLOP/s on the bf16 tensor cores.  This kernel serves fp32
// models: a plain fp32-FMA loop tiled in shared memory, exact against the
// fp32 plain version.  bf16 models take the tensor-core kernel in
// amp_conv_mma.cu.
//
// Per block: O_TILE output channels x T_TILE times of one batch item, 256
// threads, 4 x 4 outputs each.  For each chunk of 8 input channels the
// prologue evaluates the aa-snake over the T_TILE + dil (K - 1) positions
// the taps read (aa_snake.cuh, x read with a 6-sample halo) straight into
// shared memory; the 2x-rate signal and the activation never touch device
// memory.  Weights stream from device memory one chunk at a time.

#include "aa_snake.cuh"
#include "amp_conv.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // input channels per shared-memory stage

struct ConvArgs {
  const void* x;  // (B, C, T) conv input, before the activation
  const void* alpha;
  const void* beta;  // (C,) raw Snake parameters, dtype of w
  const void* w;     // (C, C, K)
  const void* bias;  // (C,)
  const void* res;   // nullable (B, C, T): added after the bias
  float* out;        // nullable (B, C, T) fp32
  const float* acc_in;  // nullable (B, C, T) fp32 running block sum
  float* acc_out;       // nullable (B, C, T) fp32
  void* fin;            // nullable (B, C, T): (acc_in + v) / n_blocks
  int res_dtype, fin_dtype, logscale;
  int C, T, K, dil;
  float n_blocks;
};

template <int O_TILE>
struct Tile {
  static constexpr int kRows = O_TILE / 4;          // thread rows, 4 channels each
  static constexpr int kCols = kThreads / kRows;    // thread columns, 4 times each
  static constexpr int kTime = 4 * kCols;           // T_TILE
};

__host__ __device__ inline int window(int t_tile, int K, int dil) { return t_tile + dil * (K - 1); }

template <int O_TILE>
__host__ inline size_t smem_bytes(int K, int dil) {
  const int W = window(Tile<O_TILE>::kTime, K, dil);
  return sizeof(float) * (static_cast<size_t>(kChunk) * (4 * W + 22) + static_cast<size_t>(O_TILE) * kChunk * K);
}

template <int O_TILE>
__global__ void __launch_bounds__(kThreads) amp_conv_kernel(ConvArgs a) {
  using Tl = Tile<O_TILE>;
  extern __shared__ float smem[];
  __shared__ aa::SnakeAB ab[kChunk];
  const int C = a.C, T = a.T, K = a.K, dil = a.dil;
  const int W = window(Tl::kTime, K, dil);
  float* xs = smem;                        // kChunk x (W + 12)
  float* ss = xs + kChunk * (W + 12);      // kChunk x (2W + 10)
  float* as = ss + kChunk * (2 * W + 10);  // kChunk x W
  float* ws = as + kChunk * W;             // O_TILE x kChunk x K

  const int t0 = blockIdx.x * Tl::kTime;
  const int o0 = blockIdx.y * O_TILE;
  const int64_t b = blockIdx.z;
  const int p0 = t0 - dil * (K - 1) / 2;  // activation position of window slot 0
  const int ty = threadIdx.x / Tl::kCols, tx = threadIdx.x % Tl::kCols;
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);

  float acc[4][4] = {};
  for (int i0 = 0; i0 < C; i0 += kChunk) {
    if (threadIdx.x < kChunk) ab[threadIdx.x] = aa::snake_ab(a.alpha, a.beta, aa::F32, a.logscale, i0 + threadIdx.x);
    aa::aa_load(x, b * C + i0, T, p0, W, kChunk, xs);
    for (int idx = threadIdx.x; idx < O_TILE * kChunk * K; idx += kThreads) {
      const int o = idx / (kChunk * K), r = idx - o * (kChunk * K);
      ws[idx] = aa::ld(w, (static_cast<int64_t>(o0 + o) * C + i0) * K + r);
    }
    __syncthreads();
    aa::aa_branch(xs, T, p0, W, kChunk, ab, ss);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kChunk * W; idx += kThreads) {
      const int c = idx / W, s = idx - c * W;
      const int pos = p0 + s;
      as[idx] = (pos >= 0 && pos < T) ? aa::aa_down(ss + c * (2 * W + 10), s) : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < kChunk; ++c) {
      const float* arow = as + c * W + tx;
      const float* wrow = ws + (ty * 4 * kChunk + c) * K;
      for (int j = 0; j < K; ++j) {
        float av[4], wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) av[q] = arow[j * dil + q * Tl::kCols];
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[r] = wrow[r * kChunk * K + j];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(wv[r], av[q], acc[r][q]);
      }
    }
    __syncthreads();
  }

  const float* bias = static_cast<const float*>(a.bias);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int o = o0 + ty * 4 + r;
    const float bo = aa::ld(bias, o);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = t0 + tx + q * Tl::kCols;
      if (t >= T) continue;
      const int64_t idx = (b * C + o) * T + t;
      float v = acc[r][q] + bo;
      if (a.res) v += aa::ld_any(a.res, a.res_dtype, idx);
      if (a.out) a.out[idx] = v;
      if (a.acc_out || a.fin) {
        const float s = (a.acc_in ? a.acc_in[idx] : 0.0f) + v;
        if (a.fin) aa::st_any(a.fin, a.fin_dtype, idx, s / a.n_blocks);
        else a.acc_out[idx] = s;
      }
    }
  }
}

template <int O_TILE>
cudaError_t launch(const ConvArgs& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<O_TILE>(a.K, a.dil);
  auto kernel = amp_conv_kernel<O_TILE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((a.T + Tile<O_TILE>::kTime - 1) / Tile<O_TILE>::kTime, a.C / O_TILE, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_tile(const ConvArgs& a, int B, cudaStream_t stream) {
  if (a.C % 64 == 0) return launch<64>(a, B, stream);
  if (a.C % 32 == 0) return launch<32>(a, B, stream);
  return launch<16>(a, B, stream);
}

}  // namespace

// One conv of an AMP chain (amp_conv.cuh): fp32 x and fp32 parameters only.
// C must be a multiple of 16, K odd.
extern "C" int amp_conv_fwd(const AmpConvParams* p, const void* x, int x_dtype, int B, int T, const void* res,
                            int res_dtype, float* out, const float* acc_in, float* acc_out, void* fin, int fin_dtype,
                            void* stream) {
  if (x_dtype != aa::F32 || p->param_dtype != aa::F32 || B <= 0 || B > 65535 || p->C <= 0 || p->C % 16 != 0 ||
      T <= 0 || p->K <= 0 || p->K % 2 == 0 || p->dil <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a{x, p->alpha, p->beta, p->w, p->bias, res, out, acc_in, acc_out, fin, res_dtype, fin_dtype, p->logscale,
             p->C, T, p->K, p->dil, p->n_blocks};
  return static_cast<int>(dispatch_tile(a, B, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
