// bf16 x bf16 -> bf16 matrix product with f32 accumulation for Hopper
// (sm_90a): wgmma fed by TMA through an mbarrier ring.  Plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel `bf16_matmul` of
// demo/image_classification/probe_int8_pallas.py (:86, inline `kern` :92,
// pallas_call :107), the bf16 twin of the int8 GEMM that the demo's probe
// times against the compiler's own dot.  Same function:
//   c[M, N] (bf16) = round_bf16( sum_k a[M, K] (bf16) * b[K, N] (bf16) )
// with every product summed in f32 and the sum rounded to bf16 once, at
// the end (the reference keeps an f32 VMEM accumulator across its K grid
// axis and casts it once in its last step).  b is read as it lies, [K, N]
// row-major: wgmma reads it as an MN-major B operand (the descriptor's
// transpose bit), so no caller transposes it.  K and the row length of b
// (ldb) are multiples of 8, one 16-byte unit, as TMA's strides must be
// (the wrapper zero-pads them, which is exact); M and N are any size.  The
// TPU block sizes and the multiple-of-512 assert have no counterpart.
//
// What bounds it: at 4096^3 the product is 137.4 GFLOP, 0.139 ms at the
// H100's 989 TFLOP/s dense bf16, while its bytes (a and b read once, c
// written once: 100.7 MB) take 0.030 ms at 3.35 TB/s.  It is bound by the
// tensor cores, which only warpgroup wgmma drives at their full rate.
//
// Design:
// - one block per 128 x 256 output tile, three warpgroups: two consumers of
//   64 rows each (wgmma m64n256k16, the 64 x 256 f32 sums in 128 registers
//   a thread) and one producer, of which one thread issues the copies;
//   setmaxnreg moves registers from the producer (40) to the consumers
//   (232);
// - a ring of 4 shared-memory stages, each a 64-deep K slice of a (128 x 64,
//   one TMA box) and b (64 x 256, four 64-column boxes), 48 KB a stage; all
//   boxes are 128 bytes wide and stored with TMA's 128-byte swizzle, which
//   is the layout the wgmma descriptors name (a K-major, b MN-major), so the
//   tensor cores read them without bank conflicts;
// - a full and an empty mbarrier per stage: the producer waits for a stage
//   to be empty, posts its byte count and issues the TMA loads, which
//   complete the full barrier; each consumer warpgroup waits for it,
//   issues 4 wgmmas (k16 each), and releases the previous stage once its
//   wgmmas have retired (one wgmma group stays in flight);
// - TMA zero-fills the boxes' parts past M, N or K, so the ragged edges
//   need no code in the main loop; the epilogue rounds the f32 sums to bf16
//   once and stores only inside M x N;
// - block x walks the M tiles fastest, so the 132 blocks in flight share
//   a few 256-column panels of b and all of a in the 50 MB L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace tlx;

constexpr int kBM = 128;                   // output rows per block
constexpr int kBN = 256;                   // output columns per block
constexpr int kBK = 64;                    // K elements per stage: 128 bytes
constexpr int kStages = 4;
constexpr int kConsumers = 2;              // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxN = 64;                  // b box width: 128 bytes
constexpr int kABytes = kBM * kBK * 2;     // 16 KB
constexpr int kBBoxBytes = kBK * kBoxN * 2;  // 8 KB
constexpr int kStageBytes = kABytes + kBBoxBytes * (kBN / kBoxN);  // 48 KB
// 1024 bytes of slack to align the stages to the 128-byte swizzle's
// 1024-byte period, then the ring, then 2 * kStages barriers
constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes + 16 * kStages;

__device__ __forceinline__ void store_pair(__nv_bfloat16* __restrict__ c,
                                           long long m, int n, long long row,
                                           int col, float v0, float v1) {
  if (row >= m) return;
  __nv_bfloat16* p = c + row * n + col;
  if ((n & 1) == 0 && col + 1 < n) {  // row * n + col even: 4-byte aligned
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < n) p[0] = __float2bfloat16_rn(v0);
    if (col + 1 < n) p[1] = __float2bfloat16_rn(v1);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
bf16_gemm(const __grid_constant__ CUtensorMap map_a,
          const __grid_constant__ CUtensorMap map_b,
          __nv_bfloat16* __restrict__ c, long long m, int n, int k_tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = ring + kStages * kStageBytes;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kStages + s)
  const int wg = threadIdx.x / 128;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer
    regs_dealloc<40>();
    if (threadIdx.x == kConsumers * 128) {
      prefetch_tensor_map(&map_a);
      prefetch_tensor_map(&map_b);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        // the first pass finds every stage empty
        mbar_wait(bars + 8 * (kStages + s), ((kt / kStages) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t sa = ring + s * kStageBytes;
        mbar_expect_tx(full, kStageBytes);
        tma_load_2d(sa, &map_a, full, kt * kBK, static_cast<int>(row0));
#pragma unroll
        for (int j = 0; j < kBN / kBoxN; ++j)
          tma_load_2d(sa + kABytes + j * kBBoxBytes, &map_b, full,
                      col0 + j * kBoxN, kt * kBK);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    regs_alloc<232>();
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(bars + 8 * s, (kt / kStages) & 1);
      const uint32_t sa = ring + s * kStageBytes + wg * 64 * 128;
      const uint32_t sb = ring + s * kStageBytes + kABytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        // a: K-major rows of 128 bytes, 8-row groups 1024 bytes apart, a
        // k16 step 32 bytes along the row.  b: MN-major, 64-column boxes
        // 8 KB apart (LBO), 8-row groups along K 1024 bytes apart (SBO), a
        // k16 step 16 rows down.
        wgmma_ss<kBN, 1>(acc, smem_desc(sa + ks * 32, 16, 1024, kSwizzle128B),
                         smem_desc(sb + ks * 16 * 128, kBBoxBytes, 1024,
                                   kSwizzle128B),
                         1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's wgmmas have retired
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(bars + 8 * (kStages + (kt - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const long long r = row0 + wg * 64 + warp * 16 + (lane >> 2);
    const int cbase = col0 + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      store_pair(c, m, n, r, cbase + 8 * j, acc[4 * j], acc[4 * j + 1]);
      store_pair(c, m, n, r + 8, cbase + 8 * j, acc[4 * j + 2],
                 acc[4 * j + 3]);
    }
  }
}

}  // namespace

// a: [m, k] bf16, b: [k, ldb] bf16 of which the first n columns are the
// operand, c: [m, n] bf16; a and b contiguous and 16-byte aligned, k and
// ldb multiples of 8, n <= ldb.  Launches on `stream` without
// synchronising; returns the cudaError_t of the launch
// (cudaErrorInvalidValue also when the driver refuses a tensor map).
extern "C" int tlx_bf16_matmul(const void* a, const void* b, void* c,
                               long long m, int n, int k, int ldb,
                               void* stream) {
  if (m <= 0 || m >= (1ll << 31) || n <= 0 || k <= 0 || k % 8 != 0 ||
      ldb % 8 != 0 || ldb < n)  // TMA coordinates are 32-bit
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(m)};
  const cuuint64_t strides_a[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box_a[2] = {kBK, kBM};
  const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(k)};
  const cuuint64_t strides_b[1] = {static_cast<cuuint64_t>(ldb) * 2};
  const cuuint32_t box_b[2] = {kBoxN, kBK};
  if (!make_bf16_map(&map_a, a, 2, dims_a, strides_a, box_a,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_bf16_map(&map_b, b, 2, dims_b, strides_b, box_b,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  static cudaError_t err = cudaFuncSetAttribute(  // once per process
      bf16_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((n + kBN - 1) / kBN));
  bf16_gemm<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(c), m, n, (k + kBK - 1) / kBK);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tlx_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
