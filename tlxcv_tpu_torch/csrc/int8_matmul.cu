// int8 x int8 -> int32 matrix product for Hopper (sm_90a), and the same
// product with the reference's requantize epilogue in its output stage.
// Plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel tlxcv_tpu/ops/pallas/matmul.py
// (`int8_matmul` :57, kernel `_kernel` :32).  Same function, exact:
//   c[M, N] (int32) = a[M, K] (int8) . b[K, N] (int8)
// with b handed over transposed, as the packed weight [N, K] the int8 Conv2d
// and Linear keep: 8-bit wgmma reads both operands K-major only, which is
// how a [M, Kp] patch matrix and a [N, Kp] weight already lie.  K is a
// multiple of 16 (the callers pad it with zeros, which is exact, and TMA
// needs 16-byte row strides); M and N are any size.
//
// The second entry, tlx_int8_matmul_requant, runs the epilogue of the
// reference's int8 Conv2d (tlxcv_tpu/nn/layers.py:251-260), which the
// reference keeps inside the conv's own output fusion, on the int32 sums
// while they are still in registers:
//   y = f32(acc) * scale[n]  (+ bias[n])  (max(y, 0) if relu)
//   out_scale: int8(clamp(rint(y / out_scale), -127, 127)), else bf16(y) or y
// with the IEEE round-to-nearest operations one by one (__fmul_rn,
// __fadd_rn, no contraction into an FMA; the quotient correctly rounded,
// as below), so it is bitwise the separate PyTorch passes of the plain
// version.  The int32 sums never
// reach device memory: the output is 1 (int8), 2 (bf16) or 4 (f32) bytes
// an element.
//
// What bounds it: at the served shapes K is short (64 to 4608) and the
// output wide, so the bytes dominate.  ResNet-50's layer1 1x1 convs at
// batch 256, 802816 x 64 . 64 x 256, move 257 MB with int32 out (0.077 ms at
// 3.35 TB/s) or 103 MB with int8 out (0.031 ms) for 26 GOP (0.013 ms at
// 1,979 TOP/s dense int8).  So the design keeps loads in flight while the
// previous tile's output is stored, stores asynchronously, and writes the
// output once, in whole 16-byte units.
//
// Design:
// - persistent: one block per SM walks output tiles of BM x BN, N fastest
//   within a row of M tiles, so the blocks in flight read each a tile once
//   from device memory and share it across its N tiles in L2 (the
//   weights, at most 4.7 MB at the served shapes, stay in L2; walking M
//   fastest re-read a once for each column of N tiles, up to 1.3x slower
//   at YOLOv3's 2304- and 4608-deep layers);
// - BN is 64, 128 or 256: 128 wherever N is a multiple of 128 (half the
//   sums a thread of 256 columns, which speeds the epilogue; a is re-read
//   from L2 only), else the smallest that covers N, so N = 255 is one
//   256-column tile with TMA's zero fill for the dead column; BM is 256
//   for BN = 64 (each consumer warpgroup two 64-row blocks: narrow outputs
//   get twice the rows a tile, halving the fixed cost a tile) and 128
//   otherwise;
// - warp-specialised: one producer thread keeps TMA loads of 128-byte K
//   slices of a [BM, 128] and b [BN, 128] in flight through a ring of 4-6
//   stages, gated by full and empty mbarriers, and runs ahead into the
//   next tiles while the consumers run this tile's epilogue; TMA's
//   128-byte swizzle is the layout the wgmma descriptors name, and its
//   zero fill covers ragged M, N and K;
// - two consumer warpgroups issue wgmma.m64nBNk32.s32.s8.s8 from shared
//   memory (s32 sums in registers, BN / 2 for each 64-row block;
//   setmaxnreg moves registers from the producer, 40, to them, 232, at
//   run time; ptxas still fits the whole kernel in the 168 registers that
//   384 threads allow, so the BN = 256 variants (N = 255, 1000), 128 sums
//   a thread, spill a few long-lived scalars, 8 to 48 bytes, which reload
//   from L1);
// - output stage: the epilogue's arithmetic on the sums in registers, the
//   results written into a shared-memory staging buffer in the 128-byte
//   (or 64-byte) swizzle, so the fragment writes hit distinct banks, then
//   one TMA tensor store (cp.async.bulk.tensor) of a 64-row, 128-byte-wide
//   box, which clips ragged M and N itself; two staging buffers a
//   warpgroup alternate, a buffer rewritten only once its store has read
//   it (cp.async.bulk.wait_group.read), so the warpgroup goes on to the
//   next box, and the next tile, while the stores drain.  TMA needs a row
//   stride of whole 16-byte units; where N * out_bytes is not (N = 255)
//   and one tile covers the whole row (N <= BN), a group of rows is one
//   contiguous, 16-byte aligned run of device memory: the rows are staged
//   back to back and copied by the warpgroup's threads in 16-byte units;
//   wider rows of such N are copied row by row in the widest unit their
//   stride allows.
// - the int8 epilogue's division by out_scale is the correctly rounded
//   quotient (what IEEE division and so PyTorch's `y / out_scale` give)
//   computed without a divide: out_scale's correctly rounded reciprocal,
//   once, then per element a product and two Markstein corrections by
//   FMA (q += (y - q * os) / os, the residual exact); round half to even
//   and the int8 cast are one add of 1.5 * 2^23 to the clamped quotient,
//   whose low byte is then the code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace tlx;

constexpr int kBK = 128;                   // K bytes per stage
constexpr int kConsumers = 2;              // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStageRow = 128;             // staging row: one store box wide
constexpr int kBufBytes = 64 * kStageRow;  // a staging buffer: 64 rows
constexpr int kStagingBytes = 2 * kBufBytes;  // per consumer warpgroup
constexpr int kPitch = kStageRow + 16;     // padded rows, the unit copy
constexpr int kSmemLimit = 232448;         // H100 opt-in maximum per block
constexpr int kMaxStages = 8;

template <int BN>
struct Cfg {
  static constexpr int kMW = BN == 64 ? 2 : 1;  // 64-row blocks a consumer
  static constexpr int kBM = 64 * kMW * kConsumers;
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kStageBytes = kABytes + BN * kBK;
  // 1024 bytes of slack to align the ring and the staging buffers to the
  // swizzle's 1024-byte period, the staging buffers, the barriers
  static constexpr int kFixed = 1024 + kConsumers * kStagingBytes + 256;
  static constexpr int kFit = (kSmemLimit - kFixed) / kStageBytes;
  static constexpr int kStages = kFit > kMaxStages ? kMaxStages : kFit;
  static constexpr size_t kSmemBytes =
      1024 + static_cast<size_t>(kStages) * kStageBytes +
      kConsumers * kStagingBytes + 16 * kStages;
};

// The output's staging row in bytes, one TMA store box wide.
template <int BN, typename OutT>
__host__ __device__ constexpr int staging_row() {
  return BN * static_cast<int>(sizeof(OutT)) < kStageRow
             ? BN * static_cast<int>(sizeof(OutT))
             : kStageRow;
}

enum StoreMode { kTmaStore = 0, kRowGroups = 1, kRowUnits = 2 };

struct Epilogue {
  const float* scale;      // [n], s_in * w_scale; unused for int32 out
  const float* bias;       // [n] or null
  const float* out_scale;  // one value, int8 out only
  int relu;
};

struct Cols {  // the epilogue's per-column values of two neighbouring columns
  float s0, s1, b0, b1;
};

template <typename OutT>
__device__ __forceinline__ Cols load_cols(const Epilogue& ep, int n, int c) {
  Cols v = {0.f, 0.f, 0.f, 0.f};
  if constexpr (!std::is_same<OutT, int32_t>::value) {
    const int c0 = c < n ? c : n - 1, c1 = c + 1 < n ? c + 1 : n - 1;
    v.s0 = __ldg(ep.scale + c0);
    v.s1 = __ldg(ep.scale + c1);
    if (ep.bias != nullptr) {
      v.b0 = __ldg(ep.bias + c0);
      v.b1 = __ldg(ep.bias + c1);
    }
  }
  return v;
}

// One output element from its int32 sum: the reference's epilogue, op by
// op in its order, each rounded as the separate PyTorch passes round it.
// `os` is out_scale, `ros` its correctly rounded reciprocal.
template <typename OutT>
__device__ __forceinline__ OutT finish(int32_t acc, float scale, float bias,
                                       const Epilogue& ep, float os,
                                       float ros) {
  if constexpr (std::is_same<OutT, int32_t>::value) {
    return acc;
  } else {
    float y = __fmul_rn(__int2float_rn(acc), scale);
    if (ep.bias != nullptr) y = __fadd_rn(y, bias);
    if (ep.relu) y = fmaxf(y, 0.f);
    if constexpr (std::is_same<OutT, int8_t>::value) {
      float q = __fmul_rn(y, ros);  // y / os, then corrected twice
      q = __fmaf_rn(__fmaf_rn(-q, os, y), ros, q);
      q = __fmaf_rn(__fmaf_rn(-q, os, y), ros, q);
      q = fminf(fmaxf(q, -127.f), 127.f);
      // + 1.5 * 2^23 rounds to an integer, half to even; the low byte of
      // the sum's bits is then the code in two's complement
      return static_cast<int8_t>(__float_as_int(__fadd_rn(q, 12582912.f)));
    } else if constexpr (std::is_same<OutT, __nv_bfloat16>::value) {
      return __float2bfloat16_rn(y);
    } else {
      return y;
    }
  }
}

// Two neighbouring elements into staging at an address aligned to their
// pair.
template <typename OutT>
__device__ __forceinline__ void stage_pair(unsigned char* p, OutT v0,
                                           OutT v1) {
  if constexpr (sizeof(OutT) == 1) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(
        static_cast<uint8_t>(v0) | (static_cast<uint8_t>(v1) << 8));
  } else if constexpr (sizeof(OutT) == 2) {
    __nv_bfloat162 v;
    v.x = v0;
    v.y = v1;
    *reinterpret_cast<__nv_bfloat162*>(p) = v;
  } else {
    using P = typename std::conditional<std::is_same<OutT, float>::value,
                                        float2, int2>::type;
    P v;
    v.x = v0;
    v.y = v1;
    *reinterpret_cast<P*>(p) = v;
  }
}

// Where a thread's fragment lies in a 64-row block: warp w holds rows
// 16w..16w+15, lane its row lane/4 (+8) and columns 2 (lane % 4) (+1) of
// each group of 8 columns.
struct Frag {
  int tid, r, c;
  __device__ __forceinline__ Frag() {
    tid = threadIdx.x % 128;
    r = (tid / 32) * 16 + ((tid % 32) >> 2);
    c = (tid % 4) * 2;
  }
};

// 64 rows by BN columns through double-buffered swizzled staging and TMA
// tensor stores of 64 x (kStageRow bytes) boxes.  `ps` counts the
// warpgroup's stores, which alternate between the two buffers.
template <int BN, typename OutT>
__device__ __forceinline__ void store_tma(
    const int32_t (&acc)[BN / 2], unsigned char* staging,
    const CUtensorMap* map_c, const Epilogue& ep, float os, float ros,
    long long m, int n, int grow0, int col0, int& ps, int wg) {
  constexpr int kOb = sizeof(OutT);
  constexpr int kW = staging_row<BN, OutT>();
  constexpr int kPW = kW / kOb;  // columns a box
  constexpr int kMask = kW == 128 ? 7 : 3;  // 128- or 64-byte swizzle
  const Frag f;
#pragma unroll
  for (int p = 0; p < BN / kPW; ++p) {
    unsigned char* buf = staging + (ps & 1) * kBufBytes;
#pragma unroll
    for (int jj = 0; jj < kPW / 8; ++jj) {
      const int j = p * (kPW / 8) + jj;
      const Cols v = load_cols<OutT>(ep, n, col0 + 8 * j + f.c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = (f.r + 8 * h) * kW + (8 * jj + f.c) * kOb;
        stage_pair<OutT>(
            buf + (at ^ (((at >> 7) & kMask) << 4)),
            finish<OutT>(acc[4 * j + 2 * h], v.s0, v.b0, ep, os, ros),
            finish<OutT>(acc[4 * j + 2 * h + 1], v.s1, v.b1, ep, os, ros));
      }
    }
    fence_proxy_async();  // the writes, before the async proxy reads them
    // the other buffer's store has read it: the next box may overwrite it
    if (f.tid == 0) bulk_wait_read<0>();
    named_barrier(1 + wg, 128);
    if (f.tid == 0 && grow0 < m) {  // TMA clips the rows past M itself
      tma_store_2d(map_c, smem_u32(buf), col0 + p * kPW, grow0);
      bulk_commit();
    }
    ++ps;
  }
}

template <int U>
struct Unit;
template <> struct Unit<8> { using T = uint2; };
template <> struct Unit<4> { using T = uint32_t; };
template <> struct Unit<2> { using T = uint16_t; };
template <> struct Unit<1> { using T = uint8_t; };

// `rows` staged rows (pitch kPitch) of `row_bytes` each to device rows
// `stride` bytes apart, in U-byte units, by the warpgroup's 128 threads.
template <int U>
__device__ __forceinline__ void copy_rows(const unsigned char* stage,
                                          unsigned char* dst, int rows,
                                          int row_bytes, long long stride,
                                          int tid) {
  using T = typename Unit<U>::T;
  const int per_row = row_bytes / U;
  const int total = rows * per_row;
  for (int i = tid; i < total; i += 128) {
    const int r = i / per_row, q = i - r * per_row;
    *reinterpret_cast<T*>(dst + r * stride + q * U) =
        *reinterpret_cast<const T*>(stage + r * kPitch + q * U);
  }
}

// 64 rows by BN columns where the row stride is no multiple of 16 bytes:
// by contiguous row groups (N <= BN) or row by row in U-byte units.
template <int BN, typename OutT>
__device__ __forceinline__ void store_copy(
    const int32_t (&acc)[BN / 2], unsigned char* stage, unsigned char* out,
    const Epilogue& ep, float os, float ros, long long m, int n,
    long long grow0, int col0, int mode, int unit, int group_rows, int wg) {
  constexpr int kOb = sizeof(OutT);
  const Frag f;
  const long long rows_left = m - grow0;
  const int rows = rows_left < 64 ? static_cast<int>(rows_left) : 64;
  const long long stride = static_cast<long long>(n) * kOb;
  if (mode == kRowUnits) {
    constexpr int kPW = staging_row<BN, OutT>() / kOb;
#pragma unroll
    for (int p = 0; p < BN / kPW; ++p) {
#pragma unroll
      for (int jj = 0; jj < kPW / 8; ++jj) {
        const int j = p * (kPW / 8) + jj;
        const Cols v = load_cols<OutT>(ep, n, col0 + 8 * j + f.c);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          stage_pair<OutT>(
              stage + (f.r + 8 * h) * kPitch + (8 * jj + f.c) * kOb,
              finish<OutT>(acc[4 * j + 2 * h], v.s0, v.b0, ep, os, ros),
              finish<OutT>(acc[4 * j + 2 * h + 1], v.s1, v.b1, ep, os, ros));
      }
      named_barrier(1 + wg, 128);
      const int cp = col0 + p * kPW;
      const int nv = n - cp < kPW ? n - cp : kPW;
      if (nv > 0 && rows > 0) {
        unsigned char* dst = out + grow0 * stride + static_cast<long long>(cp) * kOb;
        const int rb = nv * kOb;
        switch (unit) {
          case 8: copy_rows<8>(stage, dst, rows, rb, stride, f.tid); break;
          case 4: copy_rows<4>(stage, dst, rows, rb, stride, f.tid); break;
          case 2: copy_rows<2>(stage, dst, rows, rb, stride, f.tid); break;
          default: copy_rows<1>(stage, dst, rows, rb, stride, f.tid); break;
        }
      }
      named_barrier(1 + wg, 128);
    }
    return;
  }
  // N <= BN: groups of `group_rows` rows, each one contiguous, 16-byte
  // aligned run of device memory, staged back to back
  const int rb = n * kOb;
  for (int g0 = 0; g0 < 64; g0 += group_rows) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + f.c;
      const Cols v = load_cols<OutT>(ep, n, c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = f.r + 8 * h - g0;
        if (r >= 0 && r < group_rows) {
          unsigned char* p = stage + r * rb + c * kOb;
          if (c < n)
            *reinterpret_cast<OutT*>(p) =
                finish<OutT>(acc[4 * j + 2 * h], v.s0, v.b0, ep, os, ros);
          if (c + 1 < n)
            *reinterpret_cast<OutT*>(p + kOb) =
                finish<OutT>(acc[4 * j + 2 * h + 1], v.s1, v.b1, ep, os, ros);
        }
      }
    }
    named_barrier(1 + wg, 128);
    const int here = rows - g0 < group_rows ? rows - g0 : group_rows;
    if (here > 0) {
      const int bytes = here * rb;
      unsigned char* dst = out + (grow0 + g0) * stride;
      for (int i = f.tid; i < bytes / 16; i += 128)
        reinterpret_cast<uint4*>(dst)[i] =
            reinterpret_cast<const uint4*>(stage)[i];
      for (int i = (bytes & ~15) + f.tid; i < bytes; i += 128)
        dst[i] = stage[i];
    }
    named_barrier(1 + wg, 128);
  }
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
int8_gemm(const __grid_constant__ CUtensorMap map_a,
          const __grid_constant__ CUtensorMap map_b,
          const __grid_constant__ CUtensorMap map_c, OutT* __restrict__ out,
          const Epilogue ep, long long m, int n, int kp, int n_tiles,
          int tiles, int mode, int unit, int group_rows) {
  using C = Cfg<BN>;
  constexpr int S = C::kStages, MW = C::kMW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(base);
  unsigned char* staging = base + S * C::kStageBytes;
  const uint32_t bars = ring + S * C::kStageBytes + kConsumers * kStagingBytes;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (S + s)
  const int wg = threadIdx.x / 128;
  const int k_tiles = (kp + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kConsumers);
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
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row0 = (t / n_tiles) * C::kBM, col0 = (t % n_tiles) * BN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % S;
          // the first pass finds every stage empty
          mbar_wait(bars + 8 * (S + s), ((it / S) & 1) ^ 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t sa = ring + s * C::kStageBytes;
          mbar_expect_tx(full, C::kStageBytes);
          tma_load_2d(sa, &map_a, full, kt * kBK, row0);
          tma_load_2d(sa + C::kABytes, &map_b, full, kt * kBK, col0);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    regs_alloc<232>();
    float os = 1.f, ros = 1.f;
    if constexpr (std::is_same<OutT, int8_t>::value) {
      os = *ep.out_scale;
      ros = __frcp_rn(os);
    }
    if (mode == kTmaStore && threadIdx.x % 128 == 0)
      prefetch_tensor_map(&map_c);
    unsigned char* stage = staging + wg * kStagingBytes;
    int32_t acc[MW][BN / 2];
#pragma unroll
    for (int w = 0; w < MW; ++w)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[w][i] = 0;
    fence_regs(acc);
    int it = 0, ps = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long row0 = static_cast<long long>(t / n_tiles) * C::kBM;
      const int col0 = (t % n_tiles) * BN;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % S;
        mbar_wait(bars + 8 * s, (it / S) & 1);
        const uint32_t sa = ring + s * C::kStageBytes + wg * MW * 64 * kBK;
        const uint32_t sb = ring + s * C::kStageBytes + C::kABytes;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 32; ++ks) {
          // both operands K-major: rows of 128 bytes, 8-row groups 1024
          // bytes apart, a k32 step 32 bytes along the row (past K, TMA's
          // zero fill adds nothing)
#pragma unroll
          for (int w = 0; w < MW; ++w)
            wgmma_ss_s8<BN>(
                acc[w],
                smem_desc(sa + w * 64 * kBK + ks * 32, 16, 1024, kSwizzle128B),
                smem_desc(sb + ks * 32, 16, 1024, kSwizzle128B),
                kt > 0 || ks > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's wgmmas have retired
        if (kt > 0 && threadIdx.x % 128 == 0)
          mbar_arrive(bars + 8 * (S + (it - 1) % S));
      }
      wgmma_wait<0>();
      if (threadIdx.x % 128 == 0) mbar_arrive(bars + 8 * (S + (it - 1) % S));
      fence_regs(acc);
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        const long long grow0 = row0 + (wg * MW + w) * 64;
        if (mode == kTmaStore)
          store_tma<BN, OutT>(acc[w], stage, &map_c, ep, os, ros, m, n,
                              static_cast<int>(grow0), col0, ps, wg);
        else
          store_copy<BN, OutT>(acc[w], stage,
                               reinterpret_cast<unsigned char*>(out), ep, os,
                               ros, m, n, grow0, col0, mode, unit,
                               group_rows, wg);
      }
    }
    if (mode == kTmaStore && threadIdx.x % 128 == 0) bulk_wait_all();
  }
}

template <typename OutT>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<OutT, int32_t>::value ? CU_TENSOR_MAP_DATA_TYPE_INT32
         : std::is_same<OutT, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<OutT, __nv_bfloat16>::value
             ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
             : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

template <int BN, typename OutT>
cudaError_t launch_bn(const void* a, const void* b, void* c,
                      const Epilogue& ep, long long m, int n, int k,
                      cudaStream_t stream) {
  using C = Cfg<BN>;
  CUtensorMap map_a, map_b, map_c = {};
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(m)};
  const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box_a[2] = {kBK, C::kBM};
  const cuuint32_t box_b[2] = {kBK, BN};
  if (!make_tensor_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, 2, dims_a,
                       strides, box_a, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tensor_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, b, 2, dims_b,
                       strides, box_b, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  static cudaError_t attr = cudaFuncSetAttribute(  // once per process
      int8_gemm<BN, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmemBytes));
  if (attr != cudaSuccess) return attr;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int n_tiles = (n + BN - 1) / BN;
  const long long tiles = (m + C::kBM - 1) / C::kBM * n_tiles;
  if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  // the output's row stride decides the store: TMA where it is whole
  // 16-byte units, else row groups or units of what divides it
  const int rb = n * static_cast<int>(sizeof(OutT));
  const int unit = rb % 16 == 0 ? 16 : rb % 8 == 0 ? 8 : rb % 4 == 0 ? 4
                 : rb % 2 == 0 ? 2 : 1;
  int mode = kTmaStore, group_rows = 0;
  if (unit < 16 && n <= BN) {
    mode = kRowGroups;
    const int step = 16 / unit;  // rows whose bytes are a multiple of 16
    group_rows = kStagingBytes / rb / step * step;
    if (group_rows > 64) group_rows = 64;
  } else if (unit < 16) {
    mode = kRowUnits;
  } else {
    constexpr int kW = staging_row<BN, OutT>();
    const cuuint64_t dims_c[2] = {static_cast<cuuint64_t>(n),
                                  static_cast<cuuint64_t>(m)};
    const cuuint64_t strides_c[1] = {static_cast<cuuint64_t>(rb)};
    const cuuint32_t box_c[2] = {kW / static_cast<cuuint32_t>(sizeof(OutT)),
                                 64};
    if (!make_tensor_map(&map_c, map_type<OutT>(), c, 2, dims_c, strides_c,
                         box_c,
                         kW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B))
      return cudaErrorInvalidValue;
  }
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  int8_gemm<BN, OutT><<<grid, kThreads, C::kSmemBytes, stream>>>(
      map_a, map_b, map_c, static_cast<OutT*>(c), ep, m, n, k, n_tiles,
      static_cast<int>(tiles), mode, unit, group_rows);
  return cudaGetLastError();
}

template <typename OutT>
int launch(const void* a, const void* b, void* c, const Epilogue& ep,
           long long m, int n, int k, void* stream) {
  // TMA coordinates are 32-bit; K is the 16-byte row stride of both maps
  if (m <= 0 || m >= (1ll << 31) || n <= 0 || k <= 0 || k % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  // 128 columns a tile hold half the sums a thread of 256 do, which speeds
  // the epilogue, and re-read a from L2 only: 128 wherever N is a
  // multiple, 256 where one tile can then cover a ragged row (N = 255)
  cudaError_t err;
  if (n <= 64)
    err = launch_bn<64, OutT>(a, b, c, ep, m, n, k, cs);
  else if (n <= 128 || n % 128 == 0)
    err = launch_bn<128, OutT>(a, b, c, ep, m, n, k, cs);
  else
    err = launch_bn<256, OutT>(a, b, c, ep, m, n, k, cs);
  return static_cast<int>(err);
}

}  // namespace

// a: [m, k] int8, b: [n, k] int8 (the right operand transposed), c: [m, n]
// int32, all contiguous and 16-byte aligned, k a multiple of 16, m < 2^31.
// Launches on `stream` without synchronising; returns the cudaError_t of
// the launch (cudaErrorInvalidValue also when the driver refuses a tensor
// map).
extern "C" int tlx_int8_matmul_nt(const void* a, const void* b, void* c,
                                  long long m, int n, int k, void* stream) {
  const Epilogue none = {nullptr, nullptr, nullptr, 0};
  return launch<int32_t>(a, b, c, none, m, n, k, stream);
}

// The same product with the epilogue in the output stage.  scale: [n] f32;
// bias: [n] f32 or null; out_scale: one f32 on the device (read by the
// kernel, so the host never waits for it), or null; out_kind: 1 int8 (needs
// out_scale), 2 bf16, 3 f32; out: [m, n] of that type, 16-byte aligned.
extern "C" int tlx_int8_matmul_requant(const void* a, const void* b, void* out,
                                       const void* scale, const void* bias,
                                       const void* out_scale, long long m,
                                       int n, int k, int relu, int out_kind,
                                       void* stream) {
  const Epilogue ep = {static_cast<const float*>(scale),
                       static_cast<const float*>(bias),
                       static_cast<const float*>(out_scale), relu};
  if (scale == nullptr || (out_kind == 1) != (out_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (out_kind) {
    case 1: return launch<int8_t>(a, b, out, ep, m, n, k, stream);
    case 2: return launch<__nv_bfloat16>(a, b, out, ep, m, n, k, stream);
    case 3: return launch<float>(a, b, out, ep, m, n, k, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* tlx_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
