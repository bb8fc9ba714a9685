// A Linear's product on the H100's tensor cores at fp32 accuracy (3xTF32), with its bias and, optionally,
// exact (erf) GELU fused into the epilogue: out = [gelu](x w^T + bias), x (M, K), w (N, K), out (M, N),
// all fp32 and row-major.  Runs the two GEMMs of each ConvNeXt block's MLP (models/convnext.py,
// pwconv1 -> GELU -> pwconv2); ops/linear_3xtf32.py binds it and routes to it.
//
// Replaces no TPU kernel: the JAX package leaves this matmul to XLA at Precision.HIGHEST
// (vocoder_tpu/nn.py::linear, called by vocoder_tpu/models/convnext.py's blocks).  On the card the fp32
// product went to cuBLAS's SGEMM on the CUDA cores (67 TFLOP/s), since the model asks for fp32 with TF32 off.
//
// Arithmetic (as csrc/amp_conv_mma.cu's fp32 route): each operand is split into tf32 hi = rna(v) and
// lo = rna(v - hi) (rna: round to nearest, ties away from zero, the bits of cvt.rna.tf32.f32 in two
// integer operations), and each 8-deep step is three tf32 products, lo·hi + hi·lo + hi·hi, small terms
// first.  tf32 x tf32 products are exact in fp32 and only lo·lo (~2^-22 of a product) is dropped.  The
// tensor core's own adds do not round to nearest and drift over a long reduction, so the products of
// one 32-deep stage (12 wgmmas) start from zero in a partial sum that then enters the running sum by
// IEEE-rounded fp32 adds.
//
// Bound on an H100: operations.  Three tf32 passes, 3 x 2 M N K at 495 TFLOP/s, against
// (M K + 2 N K + M N) x 4 bytes at 3.35 TB/s: at the ConvNeXt's shapes (K >= 352, M in the thousands)
// the products take 10-60x longer than the bytes.  The design keeps the tensor cores fed:
//
// - Persistent blocks (one an SM) walk the output tiles in bands of kBand row tiles, so the blocks in
//   flight share their weight tiles and their activation rows in L2.
// - Warp specialisation: one producer warp keeps TMA loads in flight into a ring of kStages stages in
//   shared memory (mbarrier full/empty pairs); a stage is a 128 x 32 activation tile and the
//   WN x 32 tiles of the weight's two halves, 128-byte swizzled.
// - Two consumer warpgroups, 64 rows each.  A consumer reads its A fragments from shared memory into
//   registers and splits them there; B (the weight's hi and lo halves, split once per weight by
//   ops/linear_3xtf32.py) is read by wgmma straight from shared memory.  Each 8-deep step is three
//   wgmma.mma_async m64nWNk8 tf32 (A from registers).  A consumer waits for its stage's products
//   before it adds them up and frees the slot, so the two take turns (two named barriers): each
//   issues its stage's 12 wgmmas only after the other has issued its own, and the tensor cores run
//   one warpgroup's products while the other adds, frees and splits (5-7% faster at the
//   ConvNeXt's shapes than letting both issue together and drain together).
// - Epilogue: the running sums + bias, then GELU when asked, stored from registers (each quad of
//   threads writes 32 contiguous bytes of a row).  The ragged edges of M, N and K come from TMA's
//   zero fill of out-of-bounds boxes and predicated stores.
//
// The tile width WN (128, or 64 where 128-wide tiles would leave SMs idle) is picked by the host from
// the shapes alone.  Needs K % 4 == 0 and N % 4 == 0 (TMA's 16-byte row strides; paired stores) and
// 16-byte aligned pointers; the wrapper checks them.

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;                 // rows a block: two consumer warpgroups of 64
constexpr int kBK = 32;                  // depth a stage: one 128-byte swizzle row of fp32
constexpr int kConsumers = 2;            // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBand = 16;                // row tiles a band of the tile order
constexpr int kSmemBudget = 200 * 1024;  // the ring's bytes at most

template <int WN>
struct Cfg {
  static constexpr int kA = kBM * kBK * 4;  // activation tile bytes
  static constexpr int kB = WN * kBK * 4;   // one weight half's tile bytes
  static constexpr int kStage = kA + 2 * kB;
  static constexpr int kStages = kSmemBudget / kStage > 8 ? 8 : kSmemBudget / kStage;
  static constexpr int kAcc = WN / 2;       // fp32 sums a thread holds for its warpgroup's 64 x WN tile
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;  // + barriers + alignment
};

__device__ __forceinline__ float gelu_erf(float y) { return y * 0.5f * (1.0f + erff(y * 0.70710678118654752f)); }

struct Tile {
  int m0, n0;
};

// Output tile t of the persistent walk: bands of kBand row tiles, each band's tiles row tile fastest,
// so the blocks in flight cover a few weight tiles and a band of activation rows.
__device__ __forceinline__ Tile tile_at(int t, int m_tiles, int n_tiles, int wn) {
  const int first = t / (kBand * n_tiles) * kBand;
  const int rows = min(kBand, m_tiles - first);
  const int local = t - first * n_tiles;
  return {(first + local % rows) * kBM, (local / rows) * wn};
}

template <int WN>
__global__ void __launch_bounds__(kThreads, 1)
    linear_3xtf32_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_hi,
                         const __grid_constant__ CUtensorMap map_lo, const float* __restrict__ bias,
                         float* __restrict__ out, int M, int N, int K, int gelu) {
  using C = Cfg<WN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bars = base + C::kStages * C::kStage;  // full[s] at bars + 8 s, empty[s] after them
  const int m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + WN - 1) / WN;
  const int tiles = m_tiles * n_tiles, k_steps = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                                  // the producer's expect_tx
      mbar_init(bars + 8 * (C::kStages + s), kConsumers * 4);      // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_at(t, m_tiles, n_tiles, WN);
        for (int ks = 0; ks < k_steps; ++ks) {
          const uint32_t full = bars + 8 * s;
          mbar_wait(bars + 8 * (C::kStages + s), phase ^ 1);  // the slot's last readers are done
          mbar_expect_tx(full, C::kStage);
          const uint32_t st = base + s * C::kStage;
          tma_load(st, &map_x, ks * kBK, tl.m0, full);
          tma_load(st + C::kA, &map_hi, ks * kBK, tl.n0, full);
          tma_load(st + C::kA + C::kB, &map_lo, ks * kBK, tl.n0, full);
          if (++s == C::kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: rows 64 wg ... 64 wg + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, q = lane % 4;
    const int r0 = wg * 64 + warp * 16 + lane / 4;  // this thread's rows of the A fragments: r0 and r0 + 8
    const int swz = r0 & 7;                          // (r0 + 8) & 7 too
    int s = 0, issued = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_at(t, m_tiles, n_tiles, WN);
      float acc[C::kAcc], part[C::kAcc];
#pragma unroll
      for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.0f;
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(bars + 8 * s, phase);
        const uint8_t* st = smem + s * C::kStage;
        // A fragments of the four 8-deep steps (wgmma's register layout, as mma.sync m16n8k8's: a[v + 2h]
        // holds row r0 + 8 v, depth 8 kk + q + 4 h), read through the 128-byte swizzle and split.
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const uint32_t bits = *reinterpret_cast<const uint32_t*>(
                  st + (r0 + 8 * v) * 128 + (((2 * kk + h) ^ swz) << 4) + q * 4);
              const uint32_t b = tf32_rna(bits);
              hi[kk][v + 2 * h] = b;
              lo[kk][v + 2 * h] = tf32_rna(__float_as_uint(__fsub_rn(__uint_as_float(bits), __uint_as_float(b))));
            }
          }
          fence_regs(hi[kk]);
          fence_regs(lo[kk]);
        }
        const uint32_t b_hi = smem_u32(st + C::kA), b_lo = b_hi + C::kB;
        if (wg == 1 || issued > 0) named_sync(wg == 0 ? 2 : 1);  // the other warpgroup issued before us
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // the stage's 12 products start from zero (part)
          wgmma<WN>(part, lo[kk], b128_desc(b_hi + 32 * kk), kk > 0);
          wgmma<WN>(part, hi[kk], b128_desc(b_lo + 32 * kk), 1);
          wgmma<WN>(part, hi[kk], b128_desc(b_hi + 32 * kk), 1);
        }
        wgmma_commit();
        named_arrive(wg == 0 ? 1 : 2);
        ++issued;
        wgmma_wait0();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < C::kAcc; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 * (C::kStages + s));
        if (++s == C::kStages) {
          s = 0;
          phase ^= 1;
        }
      }
      // Epilogue: acc[4 j + 2 v + e] is row r0 + 8 v, column 8 j + 2 q + e of the warpgroup's tile.
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = tl.n0 + 8 * j + 2 * q;
        if (col < N) {  // N % 4 == 0: col + 1 < N too
          const float b0 = bias ? bias[col] : 0.0f, b1 = bias ? bias[col + 1] : 0.0f;
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int row = tl.m0 + r0 + 8 * v;
            if (row < M) {
              float y0 = acc[4 * j + 2 * v] + b0, y1 = acc[4 * j + 2 * v + 1] + b1;
              if (gelu) {
                y0 = gelu_erf(y0);
                y1 = gelu_erf(y1);
              }
              *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N + col) = make_float2(y0, y1);
            }
          }
        }
      }
    }
    if (wg == 0 && issued > 0) named_sync(2);  // warpgroup 1's last arrive, so no barrier is left half-met
  }
}

// A (rows, cols) row-major fp32 matrix, read in boxes of box_rows x kBK with the 128-byte swizzle; zeros
// outside it.
bool make_map(CUtensorMap* map, const float* p, int rows, int cols, int box_rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

// The current device's SM count, read once a device.
int sm_count() {
  static int sms_of[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (sms_of[dev] == 0 && cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms_of[dev] = 0;
  return sms_of[dev];
}

long long tiles_of(int M, int N, int wn) {
  return static_cast<long long>((M + kBM - 1) / kBM) * ((N + wn - 1) / wn);
}

template <int WN>
int launch(const float* x, const float* w_pack, const float* bias, float* out, int M, int N, int K, int gelu,
           int sms, cudaStream_t stream) {
  CUtensorMap mx, mh, ml;
  if (!make_map(&mx, x, M, K, kBM) || !make_map(&mh, w_pack, N, K, WN) ||
      !make_map(&ml, w_pack + static_cast<size_t>(N) * K, N, K, WN))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set[kMaxDevices] = {};  // the shared-memory opt-in, once a device (sm_count checked the id)
  int dev = 0;
  cudaGetDevice(&dev);
  if (!smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(linear_3xtf32_kernel<WN>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<WN>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const long long tiles = tiles_of(M, N, WN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  linear_3xtf32_kernel<WN><<<grid, kThreads, Cfg<WN>::kSmem, stream>>>(mx, mh, ml, bias, out, M, N, K, gelu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (M, N) = [gelu](x (M, K) . w^T + bias) in 3xTF32; w_pack: (2, N, K), w's tf32 hi then lo halves; bias
// (N,) or null; gelu 0 or 1.  One launch on `stream`; returns cudaGetLastError() after it.
extern "C" int linear_3xtf32(const float* x, const float* w_pack, const float* bias, float* out, int M, int N,
                             int K, int gelu, void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || K % 4 != 0 || N % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 128-wide tiles, or 64-wide where 128-wide ones number fewer than the SMs (a b1 request's few hundred rows).
  return tiles_of(M, N, 128) >= sms ? launch<128>(x, w_pack, bias, out, M, N, K, gelu, sms, s)
                                    : launch<64>(x, w_pack, bias, out, M, N, K, gelu, sms, s);
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
