// bf16 x bf16 -> bf16 matrix product with f32 accumulation for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `bf16_matmul` of
// demo/image_classification/probe_int8_pallas.py (:86, inline `kern` :92,
// pallas_call :107), the bf16 twin of the int8 GEMM that the demo's probe
// times against the compiler's own dot.  Same function:
//   c[M, N] (bf16) = round_bf16( sum_k a[M, K] (bf16) * b[K, N] (bf16) )
// with every product summed in f32 and the sum rounded to bf16 once, at
// the end (the reference keeps an f32 VMEM accumulator across its K grid
// axis and casts it once in its last step).  b is read as it lies, [K, N]
// row-major: ldmatrix has a .trans form for 16-bit elements, so no caller
// transposes it.  K and the row length of b (ldb) are multiples of 8, one
// 16-byte chunk (the wrapper zero-pads them, which is exact); M and N are
// any size, their ragged edges guarded here.  The TPU block sizes and the
// multiple-of-512 assert have no counterpart.
//
// What bounds it: at 4096^3 the product is 137.4 GFLOP, 0.139 ms at the
// H100's 989 TFLOP/s dense bf16, while its bytes (a and b read once, c
// written once: 100.7 MB) take 0.030 ms at 3.35 TB/s.  It is bound by the
// tensor cores.
//
// Design (simple first):
// - one block of 8 warps per 128 x 128 output tile; warps in a 4 x 2 grid,
//   each owning 32 x 64 outputs as 2 x 8 tiles of m16n8;
// - the product runs on the tensor cores through
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, the f32 sums kept in
//   registers across the whole K loop;
// - 32-deep K slices of a (128 x 64 bytes) and b (32 x 256 bytes) are
//   staged in shared memory by cp.async, double-buffered so the copy of
//   slice t+1 overlaps the products of slice t; rows are padded by 16
//   bytes (80 and 272 bytes) so that the eight row addresses of each
//   ldmatrix phase fall in eight distinct 16-byte bank groups; chunks past
//   M, K or ldb are zero-filled by cp.async itself;
// - A fragments come from ldmatrix.x4, B fragments from ldmatrix.x4.trans
//   on the [K, N] tile (two n8 tiles per instruction);
// - one rounding to bf16 (round to nearest even) in the epilogue, stored as
//   bf16 pairs where the row allows it.
// What holds it back: mma.sync issues from one warp at a time and the
// operands pass through registers; only Hopper's warpgroup wgmma, fed by
// TMA from a deeper ring of shared-memory stages, reaches the card's full
// bf16 rate.  That is a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;           // output rows per block
constexpr int kBN = 128;           // output columns per block
constexpr int kBK = 32;            // K elements per shared-memory slice
constexpr int kLdsA = kBK + 8;     // a row of the A slice: 80 bytes
constexpr int kLdsB = kBN + 8;     // a row of the B slice: 272 bytes
constexpr int kThreads = 256;      // 8 warps: 4 along M, 2 along N
constexpr int kWN = kBN / 2;       // output columns per warp
constexpr int kNT = kWN / 8;       // m16n8 tiles per warp along N

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with valid == false nothing is read and the 16
// destination bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__global__ void __launch_bounds__(kThreads)
bf16_gemm(const __nv_bfloat16* __restrict__ a,
          const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ c,
          long long m, int n, int k, int ldb) {
  __shared__ __align__(16) __nv_bfloat16 sa[2][kBM * kLdsA];
  __shared__ __align__(16) __nv_bfloat16 sb[2][kBK * kLdsB];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  const int ktiles = (k + kBK - 1) / kBK;

  auto load_slice = [&](int stage, int kt) {
    const int kbase = kt * kBK;
    // A: 128 rows of 4 chunks (8 bf16 each) along K
#pragma unroll
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i >> 2, ch = i & 3;
      const long long gr = row0 + r;
      const int gk = kbase + ch * 8;
      const bool ok = gr < m && gk < k;
      cp_async16(smem_u32(&sa[stage][r * kLdsA + ch * 8]),
                 ok ? a + gr * k + gk : a, ok);
    }
    // B: 32 rows (K) of 16 chunks (8 bf16 each) along N
#pragma unroll
    for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
      const int r = i >> 4, ch = i & 15;
      const int gk = kbase + r;
      const int gn = col0 + ch * 8;
      const bool ok = gk < k && gn < ldb;
      cp_async16(smem_u32(&sb[stage][r * kLdsB + ch * 8]),
                 ok ? b + static_cast<long long>(gk) * ldb + gn : b, ok);
    }
    cp_async_commit();
  };

  float acc[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  load_slice(0, 0);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < ktiles) {
      // the other stage was last read in iteration kt - 1, which ended
      // with __syncthreads
      load_slice(stage ^ 1, kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ta = sa[stage];
    const __nv_bfloat16* tb = sb[stage];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      // A: x4 = rows 0-7 / 8-15 of the m16 tile at k 0-7, then at k 8-15:
      // a0..a3 of mma.m16n8k16
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + (lane & 15);
        ldmatrix_x4(af[mt], smem_u32(ta + r * kLdsA + ks + (lane >> 4) * 8));
      }
      // B, transposed on load: x4 = (k 0-7, n 0-7), (k 8-15, n 0-7),
      // (k 0-7, n 8-15), (k 8-15, n 8-15): the b0, b1 pairs of two n8 tiles
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        const int mat = lane >> 3;
        const int kr = ks + (mat & 1) * 8 + (lane & 7);
        const int nc = wn * kWN + np * 16 + (mat >> 1) * 8;
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, smem_u32(tb + kr * kLdsB + nc));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }

  // accumulator layout of m16n8: c0, c1 at (g, 2t), (g, 2t + 1); c2, c3
  // eight rows below
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const long long r = row0 + wm * 32 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = col0 + wn * kWN + nt * 8 + t4 * 2;
      store_pair(c, m, n, r, col, acc[mt][nt][0], acc[mt][nt][1]);
      store_pair(c, m, n, r + 8, col, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

}  // namespace

// a: [m, k] bf16, b: [k, ldb] bf16 of which the first n columns are the
// operand, c: [m, n] bf16; a and b contiguous and 16-byte aligned, k and
// ldb multiples of 8, n <= ldb.  Launches on `stream` without
// synchronising; returns the cudaError_t of the launch.
extern "C" int tlx_bf16_matmul(const void* a, const void* b, void* c,
                               long long m, int n, int k, int ldb,
                               void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 8 != 0 || ldb % 8 != 0 || ldb < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((n + kBN - 1) / kBN));
  bf16_gemm<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(c),
      m, n, k, ldb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tlx_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
