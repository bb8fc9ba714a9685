// Anti-aliased Snake, device side: shared by the K1 kernel (aa_snake.cu) and
// the prologue of the AMP conv kernel (amp_conv_mma.cu).
//
// With f the 12-tap ratio-2 Kaiser-sinc filter and x one channel row of
// length T, the reference composition (2x upsample -> snake -> 2x
// downsample, both FIRs edge-replicating their input) is, exactly:
//
//   y2[2v]   = 2 * sum_j f[11-2j] * x[clamp(v-3+j, 0, T-1)]        j < 6
//   y2[2v+1] = 2 * sum_j f[10-2j] * x[clamp(v-2+j, 0, T-1)]
//   z[p]     = sum_m f[m] * snake(y2[clamp(2p+m-5, 0, 2T-1)])       m < 12
//   snake(v) = v + sin^2(alpha v) / (beta + 1e-9)
//
// Clamping at both levels reproduces the reference at the sequence edges, so
// no edge splice is needed.  A block evaluates z for a window of W outputs
// starting at p0 in three shared-memory passes:
//   aa_load:   xs[q] = x[clamp(p0 - 6 + q)]                   q < W + 12
//   aa_branch: ss[i] = snake(y2[clamp(2 p0 - 5 + i)])         i < 2W + 10
//   aa_down:   z[p0 + s] = sum_m f[m] ss[2s + m]              s < W
//
// Everything inside is fp32, and every operation is one IEEE-rounded fp32
// operation in the order of the plain version (ops/antialias.py:
// aa_snake_plain, snake, sin_sq, snake_params): the __f*_rn intrinsics keep
// nvcc from contracting a multiply and an add into an FMA.  The kernels and
// the plain version on the card then agree to the bit, so rounding z to bf16
// (the AMP convs' input) comes out the same in the two.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aa {

enum DType : int { F32 = 0, BF16 = 1 };

// kaiser_sinc_filter1d(0.25, 0.3, 12) in fp32 (vocoder_tpu_torch/ops/antialias.py;
// tests/test_torch_ops.py checks these digits against it).
static __device__ __constant__ float kFilt[12] = {
    2.028966555e-03f, 9.389463812e-03f, -2.554346435e-02f, -5.765737593e-02f,
    1.285726130e-01f, 4.432097971e-01f, 4.432097971e-01f, 1.285726130e-01f,
    -5.765737593e-02f, -2.554346435e-02f, 9.389463812e-03f, 2.028966555e-03f};

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float v) { p[i] = __float2bfloat16(v); }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float ld_any(const void* p, int dtype, int64_t i) {
  return dtype == BF16 ? ld(static_cast<const __nv_bfloat16*>(p), i) : ld(static_cast<const float*>(p), i);
}
__device__ __forceinline__ void st_any(void* p, int dtype, int64_t i, float v) {
  if (dtype == BF16) st(static_cast<__nv_bfloat16*>(p), i, v);
  else st(static_cast<float*>(p), i, v);
}

// sin^2(w) by a Cody-Waite reduction of 2w and a degree-6-in-r^2 cosine: the
// JAX package's polynomial, within 6e-7 of libm over |w| <= 300 (__sinf is
// not, at the |alpha v| of tens to hundreds that snake reaches).
__device__ __forceinline__ float sin_sq(float w) {
  const float u = mul(2.0f, w);
  const float k = rintf(mul(u, 0.15915494309189535f));
  const float r = sub(sub(sub(u, mul(k, 6.28125f)), mul(k, 0.0019350051879882812f)), mul(k, 3.0199159795074593e-07f));
  const float r2 = mul(r, r);
  float c = 1.7369133647437146e-09f;
  c = add(mul(c, r2), -2.71133732450103e-07f);
  c = add(mul(c, r2), 2.4773424196945306e-05f);
  c = add(mul(c, r2), -0.0013887970410899468f);
  c = add(mul(c, r2), 0.04166652436474753f);
  c = add(mul(c, r2), -0.4999999177267109f);
  c = add(mul(c, r2), 0.9999999922907286f);
  return sub(0.5f, mul(0.5f, c));
}

__device__ __forceinline__ float snake(float v, float alpha, float inv_beta) {
  return add(v, mul(inv_beta, sin_sq(mul(v, alpha))));
}

// Snake parameters of one channel as the activation uses them.
struct SnakeAB {
  float alpha, inv_beta;
};

__device__ __forceinline__ SnakeAB snake_ab(const void* alpha, const void* beta, int pdtype, int logscale, int c) {
  float a = ld_any(alpha, pdtype, c);
  float b = ld_any(beta, pdtype, c);
  if (logscale) {
    a = expf(a);
    b = expf(b);
  }
  return {a, __fdiv_rn(1.0f, add(b, 1e-9f))};
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// xs[c * (W + 12) + q] = x[row(c), clamp(p0 - 6 + q)] for nc channel rows.
template <typename TX>
__device__ void aa_load(const TX* x, int64_t row0, int T, int p0, int W, int nc, float* xs) {
  const int len = W + 12;
  for (int idx = threadIdx.x; idx < nc * len; idx += blockDim.x) {
    const int c = idx / len, q = idx - c * len;
    xs[idx] = ld(x, (row0 + c) * T + clampi(p0 - 6 + q, 0, T - 1));
  }
}

// ss[c * (2W + 10) + i] = snake(y2[clamp(2 p0 - 5 + i, 0, 2T - 1)]).
__device__ __forceinline__ float aa_y2(const float* xs_row, int n, int p0) {
  const int v = n >> 1;
  float y = 0.0f;
  if ((n & 1) == 0) {
    const float* p = xs_row + (v - p0 + 3);
#pragma unroll
    for (int j = 0; j < 6; ++j) y = add(y, mul(kFilt[11 - 2 * j], p[j]));
  } else {
    const float* p = xs_row + (v - p0 + 4);
#pragma unroll
    for (int j = 0; j < 6; ++j) y = add(y, mul(kFilt[10 - 2 * j], p[j]));
  }
  return mul(2.0f, y);
}

// Each thread takes one (odd, even) pair of 2x-rate samples, so the parity
// branch in aa_y2 is uniform across a warp except where an edge clamps n.
__device__ void aa_branch(const float* xs, int T, int p0, int W, int nc, const SnakeAB* ab, float* ss) {
  const int pairs = W + 5, xlen = W + 12;
  for (int idx = threadIdx.x; idx < nc * pairs; idx += blockDim.x) {
    const int c = idx / pairs, h = idx - c * pairs;
    const float* xs_row = xs + c * xlen;
    const int n0 = clampi(2 * p0 - 5 + 2 * h, 0, 2 * T - 1);
    const int n1 = clampi(2 * p0 - 4 + 2 * h, 0, 2 * T - 1);
    float* out = ss + c * (2 * pairs) + 2 * h;
    out[0] = snake(aa_y2(xs_row, n0, p0), ab[c].alpha, ab[c].inv_beta);
    out[1] = snake(aa_y2(xs_row, n1, p0), ab[c].alpha, ab[c].inv_beta);
  }
}

// z at window position s of one channel row of ss, summed as the plain version
// sums it: (f[2a] ss[2s + 2a] + f[2a + 1] ss[2s + 2a + 1]) for a = 0..5, left to right.
__device__ __forceinline__ float aa_down(const float* ss_row, int s) {
  const float* p = ss_row + 2 * s;
  float z = 0.0f;
#pragma unroll
  for (int a = 0; a < 6; ++a) z = add(z, add(mul(kFilt[2 * a], p[2 * a]), mul(kFilt[2 * a + 1], p[2 * a + 1])));
  return z;
}

}  // namespace aa
