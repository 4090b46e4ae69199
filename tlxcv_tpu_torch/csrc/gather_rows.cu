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
// once from device memory and then hit L2 (50 MB).
//
// Design (simple first):
// - one warp per output row, rows strided over the grid so any R runs on a
//   grid sized to the card (16 blocks of 8 warps per SM);
// - all 32 lanes read the row's index (one broadcast load), then copy the
//   row in the widest unit that the row width and both base pointers allow
//   (16, 8, 4, 2 or 1 bytes); a lane keeps four loads in flight before its
//   four stores, so a 2 KB row is four 512-byte waves per warp;
// - row offsets are 64-bit: at batch 32 a byte offset into the packed table
//   passes 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one row each per step
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 16;

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                   V* __restrict__ out, long long rows, long long vecs) {
  const int lane = threadIdx.x & 31;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
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

template <typename V>
cudaError_t launch(const void* table, const int* idx, void* out,
                   long long rows, long long row_bytes, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long blocks = (rows + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), rows,
      row_bytes / static_cast<long long>(sizeof(V)));
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
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fits(row_bytes, table, out, 16))
    err = launch<uint4>(table, ix, out, rows, row_bytes, cs);
  else if (fits(row_bytes, table, out, 8))
    err = launch<uint2>(table, ix, out, rows, row_bytes, cs);
  else if (fits(row_bytes, table, out, 4))
    err = launch<unsigned int>(table, ix, out, rows, row_bytes, cs);
  else if (fits(row_bytes, table, out, 2))
    err = launch<unsigned short>(table, ix, out, rows, row_bytes, cs);
  else
    err = launch<unsigned char>(table, ix, out, rows, row_bytes, cs);
  return static_cast<int>(err);
}

extern "C" const char* tlx_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
