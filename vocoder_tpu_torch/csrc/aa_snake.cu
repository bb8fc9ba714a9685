// K1: the anti-aliased Snake activation, one pass over device memory.
//
// Replaces the Pallas kernel vocoder_tpu/ops/pallas/aa_snake.py::_kernel
// (pallas_call in _interior), which BigVGAN runs as its anti-aliased Snake.
// Here it serves `activation_post` (C = 16, T = 512 F at 44.1 kHz); the AMP
// conv kernel (amp_conv_mma.cu) shares its arithmetic as a prologue.
//
// Bound on an H100: per output sample it reads one input and writes one
// output (4 or 8 bytes in bf16 or fp32) and does about 104 fp32 operations
// (two 6-tap branch FIRs, two snakes with the Cody-Waite sin polynomial, one
// 12-tap FIR), so at 67 TFLOP/s against 3.35 TB/s the CUDA cores, not the
// memory, set the bound.  The design keeps every intermediate in shared
// memory: one block loads a time tile of one channel row with a 6-sample halo,
// evaluates the 2x-rate snake once per 2x-rate sample, and decimates.  The
// sequence edges are exact by index clamping (aa_snake.cuh), with no splice.
// Layout (B, C, T) contiguous; alpha/beta are the raw (C,) parameters.

#include "aa_snake.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // outputs per block

template <typename TX>
__global__ void __launch_bounds__(kThreads)
aa_snake_kernel(const TX* __restrict__ x, TX* __restrict__ z, const void* alpha, const void* beta, int pdtype,
                int logscale, int C, int T) {
  __shared__ float xs[kTile + 12];
  __shared__ float ss[2 * kTile + 10];
  __shared__ aa::SnakeAB ab;
  const int64_t row = blockIdx.y;  // b * C + c
  const int p0 = blockIdx.x * kTile;
  const int W = min(kTile, T - p0);
  if (threadIdx.x == 0) ab = aa::snake_ab(alpha, beta, pdtype, logscale, static_cast<int>(row % C));
  aa::aa_load(x, row, T, p0, W, 1, xs);
  __syncthreads();
  aa::aa_branch(xs, T, p0, W, 1, &ab, ss);
  __syncthreads();
  for (int s = threadIdx.x; s < W; s += kThreads) aa::st(z, row * T + p0 + s, aa::aa_down(ss, s));
}

}  // namespace

// x, z: (B, C, T) of dtype x_dtype (0 fp32, 1 bf16); alpha/beta: (C,) of
// p_dtype.  Returns cudaGetLastError() after the launch.
extern "C" int aa_snake_fwd(const void* x, void* z, int x_dtype, const void* alpha, const void* beta, int p_dtype,
                            int logscale, int B, int C, int T, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0 || B * C > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((T + kTile - 1) / kTile, B * C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == aa::BF16) {
    aa_snake_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                             static_cast<__nv_bfloat16*>(z), alpha, beta, p_dtype,
                                                             logscale, C, T);
  } else {
    aa_snake_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(z), alpha,
                                                     beta, p_dtype, logscale, C, T);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
