// int8 x int8 -> int32 matrix product for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel tlxcv_tpu/ops/pallas/matmul.py
// (`int8_matmul` :57, kernel `_kernel` :32).  Same function, exact:
//   c[M, N] (int32) = a[M, K] (int8) . b[K, N] (int8)
// with b handed over transposed, as the packed weight [N, K] the int8 Conv2d
// and Linear keep: int8 mma.sync takes A row-major and B column-major only,
// so both operands must be K-contiguous, and ldmatrix has no .trans for
// 8-bit elements.  K is a multiple of 16 (the callers pad it with zeros,
// which is exact); M and N are any size, their ragged edges guarded here.
//
// What bounds it: the contract writes int32, so at ResNet-50 shapes the
// bytes dominate.  A 1x1 conv at batch 64, 200704 x 256 . 256 x 256, moves
// about 257 MB (0.077 ms at 3.35 TB/s) for 26.3 GOP (0.013 ms at 1,979
// TOP/s dense int8).  The design therefore reads each operand tile from
// device memory once per output tile and writes each int32 result once,
// in 8-byte stores that fill whole 32-byte sectors.
//
// Design (simple first; wgmma, TMA and a fused requantize epilogue come
// later):
// - one block of 8 warps per 128 x BN output tile (BN = 64 when N <= 64,
//   as in ResNet's stem and layer1, else 128); warps in a 4 x 2 grid, each
//   owning 32 x BN/2 outputs as 2 x BN/16 tiles of m16n8;
// - the product runs on the tensor cores through
//   mma.sync.m16n8k32.row.col.s32.s8.s8.s32, the int32 sums kept in
//   registers across the whole K loop;
// - 64-byte K slices of A and B are staged in shared memory by cp.async,
//   double-buffered so the copy of slice t+1 overlaps the products of
//   slice t; rows are padded to 80 bytes so ldmatrix reads hit 32 distinct
//   banks; chunks past M, N or K are zero-filled by cp.async itself;
// - fragments come from ldmatrix.x4 (no .trans): an 8 x 16-byte matrix of
//   a K-contiguous tile is exactly the s8 A and B fragment layout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;           // output rows per block
constexpr int kBK = 64;            // K bytes per shared-memory slice
constexpr int kLds = kBK + 16;     // padded row: 80 bytes, conflict-free
constexpr int kThreads = 256;      // 8 warps: 4 along M, 2 along N

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

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_pair(int32_t* __restrict__ c,
                                           long long m, int n, long long row,
                                           int col, int v0, int v1) {
  if (row >= m) return;
  int32_t* p = c + row * n + col;
  if ((n & 1) == 0 && col + 1 < n) {  // row * n + col even: 8-byte aligned
    *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
  } else {
    if (col < n) p[0] = v0;
    if (col + 1 < n) p[1] = v1;
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
int8_gemm_nt(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
             int32_t* __restrict__ c, long long m, int n, int k) {
  constexpr int WN = BN / 2;   // output columns per warp
  constexpr int NT = WN / 8;   // m16n8 tiles per warp along N
  static_assert(NT % 2 == 0, "B fragments are loaded two n8 tiles at a time");
  __shared__ __align__(16) int8_t sa[2][kBM * kLds];
  __shared__ __align__(16) int8_t sb[2][BN * kLds];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * BN;
  const int ktiles = (k + kBK - 1) / kBK;

  auto load_slice = [&](int stage, int kt) {
    const int kbase = kt * kBK;
#pragma unroll
    for (int i = tid; i < kBM * (kBK / 16); i += kThreads) {
      const int r = i >> 2, ch = i & 3;
      const long long gr = row0 + r;
      const int gk = kbase + ch * 16;
      const bool ok = gr < m && gk < k;
      cp_async16(smem_u32(&sa[stage][r * kLds + ch * 16]),
                 ok ? a + gr * k + gk : a, ok);
    }
#pragma unroll
    for (int i = tid; i < BN * (kBK / 16); i += kThreads) {
      const int r = i >> 2, ch = i & 3;
      const int gn = col0 + r;
      const int gk = kbase + ch * 16;
      const bool ok = gn < n && gk < k;
      cp_async16(smem_u32(&sb[stage][r * kLds + ch * 16]),
                 ok ? b + static_cast<long long>(gn) * k + gk : b, ok);
    }
    cp_async_commit();
  };

  int acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

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
    const int8_t* ta = sa[stage];
    const int8_t* tb = sb[stage];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      // A: x4 = rows 0-7 / 8-15 of the m16 tile, at k bytes 0-15 / 16-31
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + (lane & 15);
        ldmatrix_x4(af[mt], smem_u32(ta + r * kLds + ks + (lane >> 4) * 16));
      }
      // B: x4 = (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15),
      // (n 8-15, k 16-31): the b0, b1 pairs of two n8 tiles
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int mat = lane >> 3;
        const int r = wn * WN + np * 16 + (mat >> 1) * 8 + (lane & 7);
        uint32_t bf[4];
        ldmatrix_x4(bf, smem_u32(tb + r * kLds + ks + (mat & 1) * 16));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_s8(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_s8(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
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
    for (int nt = 0; nt < NT; ++nt) {
      const int col = col0 + wn * WN + nt * 8 + t4 * 2;
      store_pair(c, m, n, r, col, acc[mt][nt][0], acc[mt][nt][1]);
      store_pair(c, m, n, r + 8, col, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <int BN>
cudaError_t launch(const int8_t* a, const int8_t* b, int32_t* c, long long m,
                   int n, int k, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  static_cast<unsigned>((n + BN - 1) / BN));
  int8_gemm_nt<BN><<<grid, kThreads, 0, stream>>>(a, b, c, m, n, k);
  return cudaGetLastError();
}

}  // namespace

// a: [m, k] int8, b: [n, k] int8 (the right operand transposed), c: [m, n]
// int32, all contiguous and 16-byte aligned, k a multiple of 16.  Launches
// on `stream` without synchronising; returns the cudaError_t of the launch.
extern "C" int tlx_int8_matmul_nt(const void* a, const void* b, void* c,
                                  long long m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  int32_t* pc = static_cast<int32_t*>(c);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return static_cast<int>(n <= 64 ? launch<64>(pa, pb, pc, m, n, k, cs)
                                  : launch<128>(pa, pb, pc, m, n, k, cs));
}

extern "C" const char* tlx_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
