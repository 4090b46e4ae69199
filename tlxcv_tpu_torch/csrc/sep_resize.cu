// Separable resize by sparse matrices, out = A . x . B^T per image and
// channel, for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel tlxcv_tpu/ops/pallas/upsample.py
// `_apply_sep_matrices` (:158, pallas_call :164, kernel `_make_sep_kernel`
// :117 without skip).  That kernel is the body of `upsample_add_fused`'s
// backward (`_fused_up_add_bwd` :228: dx = the transposed contraction of
// the output gradient, A = Ah^T, B = Aw^T) and of `upsample2x_fused` and
// its VJP (:275-299).  The TPU runs it as two dense MXU matmuls against
// the whole [OH, IH] and [OW, IW] matrices.  Each row of those matrices has
// a handful of non-zeros (a transposed nearest 2x row has 2, a transposed
// bilinear 2x row up to 4, a 38 -> 75 row a varying number), so here the
// host hands each matrix over as its non-zeros in CSR form (row pointer,
// source index, f32 weight) and each output reads only its taps.
//
// Contract: x [N, IH, IW, C] with any element strides (a stride-0 gradient
// from `.sum()` included; the vector paths need the channels contiguous),
// f32 or bf16; out [N, OH, OW, C] contiguous, x's dtype; A given as
// (ptr_h [OH + 1], src_h, w_h) with src_h in [0, IH), B as (ptr_w [OW + 1],
// src_w, w_w) with src_w in [0, IW).
//   out[n, i, j, c] = sum_t w_w[t] * (sum_s w_h[s] * x[n, src_h[s], src_w[t], c])
// over the taps t of row j of B and s of row i of A, in CSR order: rows
// first, then columns, each sum started at 0 and taken in f32 with IEEE
// multiply and add (no fused multiply-add), rounded once to the output
// dtype.  The plain torch version takes the same taps in the same order and
// computes the same bits.
//
// Gather form: each thread computes its own outputs from the inputs it
// reads, so no atomics are needed and the result does not depend on the
// schedule.  (Scattering each input into the outputs it feeds would need
// atomics, and their order changes from run to run.)
//
// What bounds it: bytes.  Every input is read and every output written
// once: the three FPN backward calls of Mask R-CNN at batch 8, 640^2, bf16,
// C = 256 read g at 40^2, 80^2, 160^2 (137.6 MB) and write dx at 20^2, 40^2,
// 80^2 (34.4 MB), 0.051 ms in all at 3.35 TB/s.  A bilinear tap is read by
// up to four neighbouring outputs; those reads hit L1/L2.
//
// Design (simple first): one thread per output pixel and vector of channels
// (16 bytes: 8 bf16 or 4 f32 when C, the strides and the pointers allow,
// else narrower), neighbouring threads on neighbouring channels of one
// pixel so loads and stores coalesce; a grid-stride loop with 64-bit
// offsets; the taps (a few KB) read through the read-only cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 32;

struct Strides {
  long long n, h, w, c;
};

struct Csr {
  const int* ptr;
  const int* src;
  const float* w;
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_f(p[0]);
  } else {  // channels contiguous, address aligned to the pack
    const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
    for (int k = 0; k < VEC; ++k) f[k] = to_f(pk.v[k]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
sep_resize_kernel(const T* __restrict__ x, T* __restrict__ out, int n, int c,
                  int oh, int ow, Strides xs, Csr a, Csr b) {
  const int cv = c / VEC;
  const long long total = static_cast<long long>(n) * oh * ow * cv;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < total; i += step) {
    const int ch = static_cast<int>(i % cv) * VEC;
    long long p = i / cv;  // output pixel
    const int ox = static_cast<int>(p % ow);
    p /= ow;
    const int oy = static_cast<int>(p % oh);
    const long long bi = p / oh;
    const T* xb = x + bi * xs.n + ch * xs.c;
    const int s0 = __ldg(a.ptr + oy), s1 = __ldg(a.ptr + oy + 1);
    const int t0 = __ldg(b.ptr + ox), t1 = __ldg(b.ptr + ox + 1);
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    for (int t = t0; t < t1; ++t) {  // columns: the taps of row ox of B
      const T* xc = xb + static_cast<long long>(__ldg(b.src + t)) * xs.w;
      float r[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) r[k] = 0.0f;
      for (int s = s0; s < s1; ++s) {  // rows: the taps of row oy of A
        float v[VEC];
        load<T, VEC>(xc + static_cast<long long>(__ldg(a.src + s)) * xs.h, v);
        const float wh = __ldg(a.w + s);
#pragma unroll
        for (int k = 0; k < VEC; ++k) r[k] = __fadd_rn(r[k], __fmul_rn(v[k], wh));
      }
      const float ww = __ldg(b.w + t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(r[k], ww));
    }
    T* o = out + ((bi * oh + oy) * ow + ox) * c + ch;
    if constexpr (VEC == 1) {
      o[0] = from_f<T>(acc[0]);
    } else {
      Pack<T, VEC> pk;
#pragma unroll
      for (int k = 0; k < VEC; ++k) pk.v[k] = from_f<T>(acc[k]);
      *reinterpret_cast<Pack<T, VEC>*>(o) = pk;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* out, int n, int c, int oh, int ow,
                   Strides xs, Csr a, Csr b, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(n) * oh * ow * (c / VEC);
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  sep_resize_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(static_cast<const T*>(x),
                                        static_cast<T*>(out), n, c, oh, ow,
                                        xs, a, b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int vec, const void* x, void* out, int n, int c, int oh,
                     int ow, Strides xs, Csr a, Csr b, cudaStream_t stream) {
  switch (vec) {
    case 1:
      return launch<T, 1>(x, out, n, c, oh, ow, xs, a, b, stream);
    case 2:
      return launch<T, 2>(x, out, n, c, oh, ow, xs, a, b, stream);
    case 4:
      return launch<T, 4>(x, out, n, c, oh, ow, xs, a, b, stream);
    case 8:  // 16 bytes of bf16
      if constexpr (sizeof(T) == 2)
        return launch<T, 8>(x, out, n, c, oh, ow, xs, a, b, stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x_strides: four element strides (n, h, w, c).  ptr_h [oh + 1], src_h and
// w_h: the CSR taps of A; ptr_w [ow + 1], src_w and w_w: those of B (device
// pointers).  dtype 0 f32, 1 bf16; vec channels per thread (C, the strides
// and the pointers must allow it).  Returns a cudaError_t.
extern "C" int tlx_sep_resize(const void* x, void* out, int n, int c, int oh,
                              int ow, const long long* x_strides,
                              const int* ptr_h, const int* src_h,
                              const float* w_h, const int* ptr_w,
                              const int* src_w, const float* w_w, int dtype,
                              int vec, void* stream) {
  if (n <= 0 || c <= 0 || oh <= 0 || ow <= 0 || vec <= 0 || c % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{x_strides[0], x_strides[1], x_strides[2], x_strides[3]};
  const Csr a{ptr_h, src_h, w_h};
  const Csr b{ptr_w, src_w, w_w};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(vec, x, out, n, c, oh, ow, xs, a, b, cs);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(vec, x, out, n, c, oh, ow, xs, a, b, cs);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* tlx_sep_resize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
