// The host interface of K2 (amp_conv_mma.cu), for both of its routes.
//
// ops/amp_block.py builds one AmpConvParams per conv of a model once, beside
// the weights it points to, and passes it by pointer with the tensors of each
// call, so a launch is one ctypes call:
//
//   int amp_conv_fwd(const AmpConvParams* p, const void* x, int x_dtype, int B, int T,
//                    const void* res, int res_dtype, float* out, const float* acc_in,
//                    float* acc_out, void* fin, int fin_dtype, const int* lens, void* stream);
//
//   out[b, o, t] = bias[o] + sum_{i, j} w[o, i, j] * a[b, i, t + j*dil - pad] (+ res)   t < L_b
//   out[b, o, t] = 0                                                                    L_b <= t < T
//   a = aa_snake(x[b, :, :L_b]) on [0, L_b), 0 outside (the conv zero-pads the activation)
//
// L_b = lens[b] (a device int32 (B,) array, clamped to [0, T]), or T where lens is nullptr.
//
// res (nullable) is added after the bias; out (nullable) takes the fp32
// value; acc_out (nullable) takes acc_in + value (acc_in nullable: 0); fin
// (nullable) takes (acc_in + value) / n_blocks cast to fin_dtype.  Dtype
// codes are aa::DType.  Each entry returns cudaGetLastError() after its
// launch, or cudaErrorInvalidValue for arguments it does not take.
#pragma once

struct AmpConvParams {
  const void* w;      // (K, C, C), w[j, o, i], dtype param_dtype (bf16 or fp32: the route)
  const void* bias;   // (C,), dtype param_dtype
  const void* alpha;  // (C,) raw Snake parameters, dtype param_dtype
  const void* beta;
  int param_dtype;
  int logscale, C, K, dil;
  float n_blocks;  // divisor of the fin epilogue
};
