// Device code that K2's two sources share (amp_conv_mma.cu, the mma.sync kernel of both routes;
// amp_conv_wgmma.cu, the fp32 route's wgmma kernel): a call's arguments, the writer of the
// aa-snake prologue's act tile, and the epilogue's vector helpers.
#pragma once

#include "aa_snake.cuh"
#include "amp_conv.cuh"

// In the including file's anonymous namespace, as the kernels that take CallArgs are, so that their
// names stay those of the kernels before this header (tools/sass_diff.py matches kernels by name).
namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// col[r * lda] = Op::store(v): a run's values down one channel column of the act tile.
template <class Op>
struct ColOut {
  typename Op::T* col;
  int lda;
  __device__ __forceinline__ void put(int r, float v) const { col[r * lda] = Op::store(v); }
};

// col[r * lda] = Op::store(aa_snake(x)[pb + r]) for r < len, 0 where pb + r lies outside [0, T), in
// the plain version's arithmetic (aa::Exact): one aa::Run of aa_snake.cuh reading x from device
// memory.
template <class Op, typename TX>
__device__ __forceinline__ void act_rows(const TX* xrow, int T, int pb, int len, aa::Exact::Params ab,
                                         typename Op::T* col, int lda) {
  if (!aa::run_at_edge(pb, len, T)) {
    aa::Run<aa::Exact, aa::GlobalX<TX, false>, ColOut<Op>, false>{{xrow, T}, {col, lda}, pb, T, ab}.rows(len);
  } else {
    aa::Run<aa::Exact, aa::GlobalX<TX, true>, ColOut<Op>, true>{{xrow, T}, {col, lda}, pb, T, ab}.rows(len);
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
  const int* lens;  // (B,) item lengths, or nullptr: every item is T long
};

// Item b's length, clamped to [0, T].  The load is volatile so that the epilogue reads it again
// rather than holding it in a register across the main loop, where the large tiles sit at their
// register cap.
__device__ __forceinline__ int item_length(const CallArgs& c, int64_t b) {
  return c.lens ? aa::clampi(*static_cast<const volatile int*>(c.lens + b), 0, c.T) : c.T;
}

// v with the lanes from `keep` on (times at or past an item's length) set to 0.
__device__ __forceinline__ float4 keep4(float4 v, int keep) {
  return make_float4(v.x, keep > 1 ? v.y : 0.0f, keep > 2 ? v.z : 0.0f, keep > 3 ? v.w : 0.0f);
}

// The vectorised epilogue's quad at times t .. t + 3 of output row o when it reaches item b's length
// (keep = L - t < 4): the fp32 values of the lanes before L, 0 from L on, in every output.
__device__ __forceinline__ void masked_quad(const AmpConvParams& p, const CallArgs& c, const float* e, float bo,
                                            int64_t gi, int keep) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f), s = v;
  if (keep > 0) {
    v = make_float4(e[0] + bo, keep > 1 ? e[1] + bo : 0.0f, keep > 2 ? e[2] + bo : 0.0f, 0.0f);
    if (c.res) v = add4(v, keep4(ld4(c.res, c.res_dtype, gi), keep));
    if (c.acc_in) s = add4(keep4(ld4(c.acc_in, aa::F32, gi), keep), v);
    else s = v;
  }
  if (c.out) st4(c.out, aa::F32, gi, v);
  if (c.fin) {
    const float n = p.n_blocks;
    st4(c.fin, c.fin_dtype, gi, make_float4(s.x / n, s.y / n, s.z / n, s.w / n));
  } else if (c.acc_out) {
    st4(c.acc_out, aa::F32, gi, s);
  }
}

}  // namespace
