// Anti-aliased Snake, device side: one run of the activation shared by the K1
// kernel (aa_snake.cu) and the prologue of the AMP conv kernel (amp_conv_mma.cu).
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
// no edge splice is needed.  A thread evaluates z for a run of consecutive
// positions in registers (Run): one x read, two snakes and one decimating FIR
// a value, with six x values and six snake pairs live.
//
// Everything inside is fp32.  Two arithmetic policies:
// - Exact (K2's prologue): every operation is one IEEE-rounded fp32 operation
//   in the order of the plain version (ops/antialias.py: aa_snake_plain,
//   snake, sin_sq, snake_params); the __f*_rn intrinsics keep nvcc from
//   contracting a multiply and an add into an FMA.  The kernel and the plain
//   version on the card then agree to the bit, so rounding z to bf16 (the AMP
//   convs' input) comes out the same in the two.
// - Fma (K1, whose output goes to a conv in fp32 or bf16 as it is): the FIR
//   taps, the range reduction and the polynomial as FMAs, about half the
//   instructions, within a few ulps (~2e-6 at |z| ~ 5) of the plain version.
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
// 2 f, the taps of the Fma arithmetic's y2 (doubling is exact).
static __device__ __constant__ float kFilt2[12] = {
    2 * 2.028966555e-03f, 2 * 9.389463812e-03f, 2 * -2.554346435e-02f, 2 * -5.765737593e-02f,
    2 * 1.285726130e-01f, 2 * 4.432097971e-01f, 2 * 4.432097971e-01f, 2 * 1.285726130e-01f,
    2 * -5.765737593e-02f, 2 * -2.554346435e-02f, 2 * 9.389463812e-03f, 2 * 2.028966555e-03f};

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

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// exp'ed (under logscale) alpha and beta of channel c, the exp rounded to the
// parameters' dtype as the plain version (antialias.snake_params) rounds it.
__device__ __forceinline__ float2 snake_params(const void* alpha, const void* beta, int pdtype, int logscale, int c) {
  float a = ld_any(alpha, pdtype, c);
  float b = ld_any(beta, pdtype, c);
  if (logscale) {
    a = expf(a);
    b = expf(b);
    if (pdtype == BF16) {
      a = __bfloat162float(__float2bfloat16_rn(a));
      b = __bfloat162float(__float2bfloat16_rn(b));
    }
  }
  return make_float2(a, b);
}

// cos(r) = sum_i kCos[i] r^(2i) on [-pi, pi]: the JAX package's polynomial.
#define AA_COS                                                                                    \
  0.9999999922907286f, -0.4999999177267109f, 0.04166652436474753f, -0.0013887970410899468f,       \
      2.4773424196945306e-05f, -2.71133732450103e-07f, 1.7369133647437146e-09f

// The plain version's operations in its order.
struct Exact {
  struct Params {
    float alpha, inv_beta;
  };
  static __device__ __forceinline__ Params params(const void* alpha, const void* beta, int pdtype, int logscale,
                                                  int c) {
    const float2 ab = snake_params(alpha, beta, pdtype, logscale, c);
    return {ab.x, __fdiv_rn(1.0f, add(ab.y, 1e-9f))};
  }
  // sin^2(w) by a Cody-Waite reduction of 2w and a degree-6-in-r^2 cosine,
  // within 6e-7 of libm over |w| <= 300 (__sinf is not, at the |alpha v| of
  // tens to hundreds that snake reaches).
  static __device__ __forceinline__ float sin_sq(float w) {
    const float u = mul(2.0f, w);
    const float k = rintf(mul(u, 0.15915494309189535f));
    const float r = sub(sub(sub(u, mul(k, 6.28125f)), mul(k, 0.0019350051879882812f)), mul(k, 3.0199159795074593e-07f));
    const float r2 = mul(r, r);
    constexpr float kCos[7] = {AA_COS};
    float c = kCos[6];
#pragma unroll
    for (int i = 5; i >= 0; --i) c = add(mul(c, r2), kCos[i]);
    return sub(0.5f, mul(0.5f, c));
  }
  static __device__ __forceinline__ float snake(float v, const Params& p) {
    return add(v, mul(p.inv_beta, sin_sq(mul(v, p.alpha))));
  }
  // y2 of one parity from six x values w(j), j < 6: 2 sum_j f[tap0 - 2j] w(j).
  template <class W>
  static __device__ __forceinline__ float y2(int tap0, const W& w) {
    float y = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) y = add(y, mul(kFilt[tap0 - 2 * j], w(j)));
    return mul(2.0f, y);
  }
  // y2 at both parities (tap0 10 and 11), the two sums interleaved term by term: the order in
  // which K2's prologue was built and measured (its SASS follows the source order).
  static __device__ __forceinline__ void y2_pair(const float (&w)[6], int slot, float& yo, float& ye) {
    yo = 0.0f;
    ye = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      yo = add(yo, mul(kFilt[10 - 2 * j], w[(slot + j) % 6]));
      ye = add(ye, mul(kFilt[11 - 2 * j], w[(slot + j) % 6]));
    }
    yo = mul(2.0f, yo);
    ye = mul(2.0f, ye);
  }
  // The decimating FIR over the snake pairs in slots slot + 1 .. slot + 6, summed as the plain
  // version sums it: (f[2a] e + f[2a + 1] o) for a = 0..5, left to right.
  static __device__ __forceinline__ float down(const float (&e)[6], const float (&o)[6], int slot) {
    float z = 0.0f;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const int k = (slot + 1 + a) % 6;
      z = add(z, add(mul(kFilt[2 * a], e[k]), mul(kFilt[2 * a + 1], o[k])));
    }
    return z;
  }
};

// The same function in FMAs.  y2 takes the doubled taps (exact: a power of two).  The snake is
// v + r2 D(r2) with r the reduction of u = 2 alpha v (2 alpha exact) by 2 pi in two FMA steps
// after a round-to-nearest by the 1.5 * 2^23 shifter (|u| / 2 pi < 2^22), and D the cosine's
// terms i >= 1 scaled by -inv_beta / 2 once per channel: v + inv_beta (1 - cos r) / 2, where
// the constant term is 1 in fp32.  12 instructions a snake against 27.
struct Fma {
  struct Params {
    float alpha2, d[6];
  };
  static __device__ __forceinline__ Params params(const void* alpha, const void* beta, int pdtype, int logscale,
                                                  int c) {
    const float2 ab = snake_params(alpha, beta, pdtype, logscale, c);
    const float h = -0.5f / (ab.y + 1e-9f);
    constexpr float kCos[7] = {AA_COS};
    Params p;
    p.alpha2 = 2.0f * ab.x;
#pragma unroll
    for (int i = 0; i < 6; ++i) p.d[i] = h * kCos[i + 1];
    return p;
  }
  static __device__ __forceinline__ float snake(float v, const Params& p) {
    constexpr float kShift = 12582912.0f;                       // 1.5 * 2^23
    constexpr float kTwoPiHi = 6.28318548202514648f;            // fp32(2 pi)
    constexpr float kTwoPiLo = -1.7484555314695172e-07f;        // 2 pi - kTwoPiHi
    const float u = __fmul_rn(v, p.alpha2);
    const float k = __fsub_rn(__fmaf_rn(u, 0.15915494309189535f, kShift), kShift);
    const float r = __fmaf_rn(-k, kTwoPiLo, __fmaf_rn(-k, kTwoPiHi, u));
    const float r2 = __fmul_rn(r, r);
    float c = p.d[5];
#pragma unroll
    for (int i = 4; i >= 0; --i) c = __fmaf_rn(c, r2, p.d[i]);
    return __fmaf_rn(c, r2, v);
  }
  template <class W>
  static __device__ __forceinline__ float y2(int tap0, const W& w) {
    float y = __fmul_rn(kFilt2[tap0], w(0));
#pragma unroll
    for (int j = 1; j < 6; ++j) y = __fmaf_rn(kFilt2[tap0 - 2 * j], w(j), y);
    return y;
  }
  static __device__ __forceinline__ void y2_pair(const float (&w)[6], int slot, float& yo, float& ye) {
    const auto wj = [&](int j) { return w[(slot + j) % 6]; };
    yo = y2(10, wj);
    ye = y2(11, wj);
  }
  static __device__ __forceinline__ float down(const float (&e)[6], const float (&o)[6], int slot) {
    float z = 0.0f;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const int k = (slot + 1 + a) % 6;
      z = __fmaf_rn(kFilt[2 * a], e[k], z);
      z = __fmaf_rn(kFilt[2 * a + 1], o[k], z);
    }
    return z;
  }
};

// x of one channel row read from device memory, clamped to [0, T) where kClamp.
template <typename TX, bool kClamp>
struct GlobalX {
  const TX* row;
  int T;
  __device__ __forceinline__ float at(int q) const { return ld(row, kClamp ? clampi(q, 0, T - 1) : q); }
};

// y2[clamp(n)] of row xrow, x clamped to [0, T).
template <class A, typename TX>
__device__ __forceinline__ float y2_at(const TX* xrow, int T, int n) {
  n = clampi(n, 0, 2 * T - 1);
  const int v = n >> 1, par = n & 1;
  return A::y2(11 - par, [&](int j) { return ld(xrow, clampi(v - 3 + par + j, 0, T - 1)); });
}

// One run of activation values, out.put(r, aa_snake(x)[pb + r]) for r < len, in arithmetic A.  Pair
// m holds the snake values at 2x-rate indices 2 pb - 5 + 2m (e) and 2 pb - 4 + 2m (o); value r is
// the decimating FIR over pairs r .. r + 5.  Pair m sits in slot m % 6 and xw[(m + j) % 6] =
// x[pb - 5 + m + j]: with the loops unrolled by six the windows rotate by index, not by moves, and
// six pairs and six x values are live.  Src reads x at a position (Src::at) and holds the row in
// device memory (Src::row); a run near a sequence edge (kEdge) reads x clamped to [0, T), takes
// y2[0] and y2[2T - 1], read from the row, for 2x-rate indices past the ends, and puts 0 for
// positions outside [0, T): the same arithmetic as inside, a few selects more.  T is the row's
// length: a row of a padded batch passes its own, and its padding is never read.
template <class A, class Src, class Out, bool kEdge>
struct Run {
  Src x;
  Out out;
  int pb, T;
  typename A::Params ab;
  float y2_lo, y2_hi;
  float xw[6], e[6], o[6];

  __device__ __forceinline__ float y2_edge(float y, int n) const {
    return n < 0 ? y2_lo : (n > 2 * T - 1 ? y2_hi : y);
  }
  __device__ __forceinline__ void start() {  // x for pair 0, then pairs 0 .. 4
    if (kEdge) {
      y2_lo = y2_at<A>(x.row, T, 0);
      y2_hi = y2_at<A>(x.row, T, 2 * T - 1);
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) xw[j] = x.at(pb - 5 + j);
#pragma unroll
    for (int m = 0; m < 5; ++m) pair(m, m);
  }
  __device__ __forceinline__ void pair(int m, int slot) {
    xw[(slot + 5) % 6] = x.at(pb + m);
    float yo, ye;  // y2 at the odd index 2 pb - 5 + 2m and the even one after it
    A::y2_pair(xw, slot, yo, ye);
    if (kEdge) {
      yo = y2_edge(yo, 2 * pb - 5 + 2 * m);
      ye = y2_edge(ye, 2 * pb - 4 + 2 * m);
    }
    e[slot] = A::snake(yo, ab);
    o[slot] = A::snake(ye, ab);
  }
  __device__ __forceinline__ void step(int m, int slot) {  // pair m, then value m - 5
    pair(m, slot);
    float z = A::down(e, o, slot);
    if (kEdge && (pb + m - 5 < 0 || pb + m - 5 >= T)) z = 0.0f;
    out.put(m - 5, z);
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

// Whether a run of len values from pb reads x or y2 past a sequence end (Run's kEdge).
__device__ __forceinline__ bool run_at_edge(int pb, int len, int T) { return pb < 5 || pb + len + 4 > T - 1; }

}  // namespace aa
