// Row gather out[r, :] = table[idx[r], :] for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernels tlxcv_tpu/ops/pallas/gather.py
// (`gather_rows` :55, async-DMA kernel `_kernel` :36, and `gather_rows_bs`
// :90, BlockSpec kernel `_bs_kernel` :82): one function, two names.  It is
// the hot op of Mask R-CNN's RoIAlign (tlxcv_tpu/ops/roi_align.py:86-141),
// which gathers rows of a packed [N * sum(HW), 4C] pyramid table, each row
// holding the four bilinear corners of one sample.
//
// Contract: table [N, row_bytes] contiguous, any dtype (the copy is
// byte-exact); idx [R] int32, every index in [0, N), as the callers build
// them (RoIAlign's indices are clamped by construction).  Indices are not
// checked here: that would need a read back to the host.
//
// What bounds it: pure data movement, no arithmetic.  Each output row is
// read once from the table and written once, so the least time is
// 2 * R * row_bytes over the memory rate: at batch 16, 640^2, the box
// branch moves 200,704 rows of 2,048 bytes (0.245 ms at 3.35 TB/s) and the
// mask branch 313,600 (0.383 ms).  Rows that several samples share are read
// once from device memory and then hit L2 (50 MB).  At 3.35 TB/s and about
// a microsecond of latency, an SM must keep some 25 KB in flight to reach
// the memory rate (Little's law over 132 SMs).
//
// Design, where rows are a multiple of 16 bytes wide, at most kSlotBytes,
// and both bases 16-byte aligned (the served 2,048-byte rows):
// - one warp a block, three blocks an SM; each block walks chunks of
//   consecutive output rows (as many as fill an 8 KB slot, at most 32)
//   strided over the grid, through a ring of 8 slots in shared memory, so
//   an SM keeps up to 24 slots, 192 KB, in flight;
// - a chunk's rows are fetched by Hopper's bulk async copy
//   (cp.async.bulk ... mbarrier::complete_tx), one lane a row, into the
//   slot; the lanes load the indices of the block's next chunk while this
//   one's copies fly;
// - once the slot's mbarrier completes, lane 0 writes the whole chunk back
//   with one bulk store (cp.async.bulk.global.shared::cta.bulk_group): the
//   output rows of a chunk are one contiguous run; the stores carry an L2
//   evict-first policy, so the output streaming through L2 does not push
//   out the table rows that the samples share;
// - a slot is refilled once its store has read it
//   (cp.async.bulk.wait_group.read), one iteration behind, so the next
//   loads never wait for the store just issued.
// Other rows (a width or base that is no multiple of 16 bytes, or rows
// wider than a slot) take the warp copy inside the same kernel: one warp a
// row, rows strided over the grid, each lane four loads in flight before
// its four stores, in the widest unit that the row width and both bases
// allow (16, 8, 4, 2 or 1 bytes).  Row offsets are 64-bit: at batch 32 a
// byte offset into the packed table passes 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace tlx;

constexpr int kSlotBytes = 8192;
constexpr int kSlots = 8;
constexpr int kBulkBlocksPerSm = 3;
constexpr size_t kBulkSmem = kSlots * kSlotBytes + 8 * kSlots;
constexpr int kWarpThreads = 256;  // the warp copy: 8 warps, one row each
constexpr int kWarpBlocksPerSm = 16;

// The bulk path, run by one warp: chunks of `per_chunk` rows.
__device__ __forceinline__ void gather_bulk(const unsigned char* table,
                                            const int* __restrict__ idx,
                                            unsigned char* out,
                                            long long rows, int row_bytes,
                                            int per_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  const uint32_t bars = ring + kSlots * kSlotBytes;
  const int lane = threadIdx.x;
  const long long chunks = (rows + per_chunk - 1) / per_chunk;
  if (blockIdx.x >= chunks) return;
  const long long n = (chunks - 1 - blockIdx.x) / gridDim.x + 1;  // mine
  if (lane == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(bars + 8 * s, 1);
    fence_barrier_init();
  }
  __syncwarp();

  // the i-th chunk of this block: its first row and row count
  auto first_row = [&](long long i) {
    return (blockIdx.x + i * gridDim.x) * per_chunk;
  };
  auto count = [&](long long r0) {
    return static_cast<int>(rows - r0 < per_chunk ? rows - r0 : per_chunk);
  };
  // this lane's index in chunk i, loaded ahead of its use
  auto index_of = [&](long long i) {
    const long long r = first_row(i) + lane;
    return i < n && lane < count(first_row(i)) ? __ldg(idx + r) : 0;
  };
  auto issue = [&](long long i, int src) {
    const int s = static_cast<int>(i % kSlots);
    const uint32_t bar = bars + 8 * s;
    const int k = count(first_row(i));
    if (lane == 0) mbar_expect_tx(bar, static_cast<uint32_t>(k) * row_bytes);
    __syncwarp();
    if (lane < k)
      bulk_load(ring + s * kSlotBytes + lane * row_bytes,
                table + static_cast<long long>(src) * row_bytes, row_bytes,
                bar);
  };

  const long long prologue = n < kSlots ? n : kSlots;
  const uint64_t evict_first = l2_evict_first();
  int next = index_of(0);
  for (long long i = 0; i < prologue; ++i) {
    const int src = next;
    next = index_of(i + 1);
    issue(i, src);
  }
  // `next` now holds the indices of chunk `prologue`, the first refill
  for (long long i = 0; i < n; ++i) {
    const int s = static_cast<int>(i % kSlots);
    mbar_wait(bars + 8 * s, static_cast<uint32_t>((i / kSlots) & 1));
    if (lane == 0) {
      const long long r0 = first_row(i);
      bulk_store(out + r0 * row_bytes, ring + s * kSlotBytes,
                 static_cast<uint32_t>(count(r0)) * row_bytes, evict_first);
      bulk_commit();
    }
    const long long refill = i - 1 + kSlots;  // into chunk i - 1's slot
    if (i >= 1 && refill < n) {
      if (lane == 0) bulk_wait_read<1>();  // chunk i - 1's store has read
      __syncwarp();
      const int src = next;
      next = index_of(refill + 1);
      issue(refill, src);
    }
  }
  if (lane == 0) bulk_wait_all();
}

// The warp copy: one warp an output row, rows strided over the grid.
template <typename V>
__device__ __forceinline__ void gather_warp(const V* __restrict__ table,
                                            const int* __restrict__ idx,
                                            V* __restrict__ out,
                                            long long rows, long long vecs) {
  const int lane = threadIdx.x & 31;
  const long long first =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x / 32;
  for (long long r = first; r < rows; r += step) {
    const V* src = table + static_cast<long long>(__ldg(idx + r)) * vecs;
    V* dst = out + r * vecs;
    long long v = lane;
    for (; v + 96 < vecs; v += 128) {
      const V a = __ldg(src + v);
      const V b = __ldg(src + v + 32);
      const V c = __ldg(src + v + 64);
      const V d = __ldg(src + v + 96);
      dst[v] = a;
      dst[v + 32] = b;
      dst[v + 64] = c;
      dst[v + 96] = d;
    }
    for (; v < vecs; v += 32) dst[v] = __ldg(src + v);
  }
}

// per_chunk > 0: the bulk path (V is uint4); else the warp copy in units
// of V.
template <typename V>
__global__ void gather_rows_kernel(const void* table, const int* idx,
                                   void* out, long long rows,
                                   long long row_bytes, int per_chunk) {
  if constexpr (sizeof(V) == 16) {
    if (per_chunk > 0) {  // row_bytes <= kSlotBytes
      gather_bulk(static_cast<const unsigned char*>(table), idx,
                  static_cast<unsigned char*>(out), rows,
                  static_cast<int>(row_bytes), per_chunk);
      return;
    }
  }
  gather_warp<V>(static_cast<const V*>(table), idx, static_cast<V*>(out),
                 rows, row_bytes / static_cast<long long>(sizeof(V)));
}

long long min_ll(long long a, long long b) { return a < b ? a : b; }

template <typename V>
cudaError_t launch_warp(const void* table, const int* idx, void* out,
                        long long rows, long long row_bytes, int sms,
                        cudaStream_t stream) {
  constexpr int kWarps = kWarpThreads / 32;
  const long long blocks = min_ll((rows + kWarps - 1) / kWarps,
                                  static_cast<long long>(sms) * kWarpBlocksPerSm);
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks), kWarpThreads, 0,
                          stream>>>(table, idx, out, rows, row_bytes, 0);
  return cudaGetLastError();
}

cudaError_t launch_bulk(const void* table, const int* idx, void* out,
                        long long rows, long long row_bytes, int sms,
                        cudaStream_t stream) {
  static cudaError_t attr = cudaFuncSetAttribute(  // once per process
      gather_rows_kernel<uint4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBulkSmem));
  if (attr != cudaSuccess) return attr;
  long long per_chunk = kSlotBytes / row_bytes;
  if (per_chunk > 32) per_chunk = 32;  // one lane a row
  const long long chunks = (rows + per_chunk - 1) / per_chunk;
  const long long blocks =
      min_ll(chunks, static_cast<long long>(sms) * kBulkBlocksPerSm);
  gather_rows_kernel<uint4><<<static_cast<unsigned>(blocks), 32, kBulkSmem,
                              stream>>>(table, idx, out, rows, row_bytes,
                                        static_cast<int>(per_chunk));
  return cudaGetLastError();
}

bool fits(long long row_bytes, const void* a, const void* b, int unit) {
  return row_bytes % unit == 0 && reinterpret_cast<uintptr_t>(a) % unit == 0 &&
         reinterpret_cast<uintptr_t>(b) % unit == 0;
}

}  // namespace

// table [*, row_bytes] and out [rows, row_bytes], both contiguous; idx
// [rows] int32.  Returns a cudaError_t (0 on success).
extern "C" int tlx_gather_rows(const void* table, const void* idx, void* out,
                               long long rows, long long row_bytes,
                               void* stream) {
  if (rows <= 0 || row_bytes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fits(row_bytes, table, out, 16) && row_bytes <= kSlotBytes)
    err = launch_bulk(table, ix, out, rows, row_bytes, sms, cs);
  else if (fits(row_bytes, table, out, 16))
    err = launch_warp<uint4>(table, ix, out, rows, row_bytes, sms, cs);
  else if (fits(row_bytes, table, out, 8))
    err = launch_warp<uint2>(table, ix, out, rows, row_bytes, sms, cs);
  else if (fits(row_bytes, table, out, 4))
    err = launch_warp<unsigned int>(table, ix, out, rows, row_bytes, sms, cs);
  else if (fits(row_bytes, table, out, 2))
    err = launch_warp<unsigned short>(table, ix, out, rows, row_bytes, sms,
                                      cs);
  else
    err = launch_warp<unsigned char>(table, ix, out, rows, row_bytes, sms, cs);
  return static_cast<int>(err);
}

extern "C" const char* tlx_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
