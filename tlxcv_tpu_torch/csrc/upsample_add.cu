// Fused resize + add, out = resize(x, skip.hw) + skip, for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel tlxcv_tpu/ops/pallas/upsample.py
// (`upsample_add_fused` :242, kernel `_make_sep_kernel(with_skip=True)` :117
// via `_apply_sep_matrices_add` :183), forward only.  The TPU kernel runs
// the resize as two MXU matmuls against the dense separable matrices of
// `_resize_matrix` (:40).  Each row of those matrices has at most two
// non-zero taps, so here each output pixel reads its taps directly: one
// source pixel for nearest, 2 x 2 for half-pixel bilinear.
//
// Contract: NHWC x [N, H, W, C] and skip [N, OH, OW, C] with OH >= H and
// OW >= W, any element strides (the vector paths need the channels
// contiguous), f32 or bf16, one dtype; out [N, OH, OW, C] contiguous.
// Taps and clamps are those of `_resize_matrix`, worked out per pixel:
// nearest src = (o * n_in) / n_out in integers; bilinear src = (o + 0.5) *
// n_in / n_out - 0.5 in float64, i0 = clamp(floor(src)), i1 = min(i0 + 1,
// n_in - 1), w1 = clamp(src - floor(src), 0, 1) and 0 for src < 0, the
// weights rounded to f32 as the matrix is (both taps on one source sum to
// one weight).  Rows first, then columns, summed in f32 with IEEE multiply
// and add (no fused multiply-add, so the plain torch version computes the
// same bits), plus skip in f32, rounded once to the output dtype.
//
// What bounds it: bytes.  x, skip and out each cross device memory once,
// (|x| + |skip| + |out|) over the memory rate: the three FPN top-down calls
// of Mask R-CNN at batch 16, 640^2, bf16, C = 256 (20->40, 40->80, 80->160)
// move 29.5 + 118.0 + 471.9 MB, 0.185 ms in all at 3.35 TB/s.  A bilinear
// tap pixel is read by up to four neighbouring outputs; those reads hit
// L1/L2.
//
// Design (simple first): one thread per output pixel and vector of
// channels (16 bytes: 8 bf16 or 4 f32 when C, the strides and the pointers
// allow, else narrower), neighbouring threads on neighbouring channels of
// one pixel so every load and store is coalesced; a grid-stride loop with
// 64-bit offsets over N * OH * OW * C / VEC items.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 32;

struct Strides {
  long long n, h, w, c;
};

struct Taps {
  int i0, i1;
  float a0, a1;
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

// One row of `_resize_matrix(n_out, n_in, mode)` as its two taps.
__device__ __forceinline__ Taps taps(int o, int n_in, int n_out,
                                     bool nearest) {
  Taps t;
  if (nearest) {
    long long s = static_cast<long long>(o) * n_in / n_out;
    s = s < 0 ? 0 : (s > n_in - 1 ? n_in - 1 : s);
    t.i0 = t.i1 = static_cast<int>(s);
    t.a0 = 1.0f;
    t.a1 = 0.0f;
    return t;
  }
  const double src = __dsub_rn(
      __ddiv_rn(__dmul_rn(static_cast<double>(o) + 0.5,
                          static_cast<double>(n_in)),
                static_cast<double>(n_out)),
      0.5);
  const double fl = floor(src);
  const double lo = fmin(fmax(fl, 0.0), static_cast<double>(n_in - 1));
  t.i0 = static_cast<int>(lo);
  t.i1 = min(t.i0 + 1, n_in - 1);
  double w1 = fmin(fmax(__dsub_rn(src, fl), 0.0), 1.0);
  if (src < 0.0) w1 = 0.0;
  const float a0 = static_cast<float>(__dsub_rn(1.0, w1));
  if (t.i1 == t.i0) {  // the matrix adds both weights into one entry
    t.a0 = static_cast<float>(__dadd_rn(static_cast<double>(a0), w1));
    t.a1 = 0.0f;
  } else {
    t.a0 = a0;
    t.a1 = static_cast<float>(w1);
  }
  return t;
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
upsample_add_kernel(const T* __restrict__ x, const T* __restrict__ skip,
                    T* __restrict__ out, int n, int h, int w, int c, int oh,
                    int ow, Strides xs, Strides ss, int nearest) {
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
    const long long b = p / oh;
    const Taps ty = taps(oy, h, oh, nearest != 0);
    const Taps tx = taps(ox, w, ow, nearest != 0);
    const T* xb = x + b * xs.n + ch * xs.c;
    float acc[VEC];
    load<T, VEC>(xb + ty.i0 * xs.h + tx.i0 * xs.w, acc);
    if (!nearest) {
      float v01[VEC], v10[VEC], v11[VEC];
      load<T, VEC>(xb + ty.i0 * xs.h + tx.i1 * xs.w, v01);
      load<T, VEC>(xb + ty.i1 * xs.h + tx.i0 * xs.w, v10);
      load<T, VEC>(xb + ty.i1 * xs.h + tx.i1 * xs.w, v11);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        // rows first (column i0 and column i1), then columns
        const float c0 = __fadd_rn(__fmul_rn(acc[k], ty.a0),
                                   __fmul_rn(v10[k], ty.a1));
        const float c1 = __fadd_rn(__fmul_rn(v01[k], ty.a0),
                                   __fmul_rn(v11[k], ty.a1));
        acc[k] = __fadd_rn(__fmul_rn(c0, tx.a0), __fmul_rn(c1, tx.a1));
      }
    }
    float s[VEC];
    load<T, VEC>(skip + b * ss.n + oy * ss.h + ox * ss.w + ch * ss.c, s);
    T* o = out + ((b * oh + oy) * ow + ox) * c + ch;
    if constexpr (VEC == 1) {
      o[0] = from_f<T>(__fadd_rn(acc[0], s[0]));
    } else {
      Pack<T, VEC> pk;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        pk.v[k] = from_f<T>(__fadd_rn(acc[k], s[k]));
      *reinterpret_cast<Pack<T, VEC>*>(o) = pk;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* skip, void* out, int n, int h,
                   int w, int c, int oh, int ow, Strides xs, Strides ss,
                   int nearest, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(n) * oh * ow * (c / VEC);
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  upsample_add_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0,
                                stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(skip),
      static_cast<T*>(out), n, h, w, c, oh, ow, xs, ss, nearest);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int vec, const void* x, const void* skip, void* out,
                     int n, int h, int w, int c, int oh, int ow, Strides xs,
                     Strides ss, int nearest, cudaStream_t stream) {
  switch (vec) {
    case 1:
      return launch<T, 1>(x, skip, out, n, h, w, c, oh, ow, xs, ss, nearest,
                          stream);
    case 2:
      return launch<T, 2>(x, skip, out, n, h, w, c, oh, ow, xs, ss, nearest,
                          stream);
    case 4:
      return launch<T, 4>(x, skip, out, n, h, w, c, oh, ow, xs, ss, nearest,
                          stream);
    case 8:  // 16 bytes of bf16
      if constexpr (sizeof(T) == 2)
        return launch<T, 8>(x, skip, out, n, h, w, c, oh, ow, xs, ss,
                            nearest, stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x_strides / skip_strides: four element strides (n, h, w, c) each.
// mode 0 nearest, 1 bilinear; dtype 0 f32, 1 bf16; vec channels per thread
// (C, the strides and the pointers must allow it).  Returns a cudaError_t.
extern "C" int tlx_upsample_add(const void* x, const void* skip, void* out,
                                int n, int h, int w, int c, int oh, int ow,
                                const long long* x_strides,
                                const long long* skip_strides, int mode,
                                int dtype, int vec, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || oh < h || ow < w ||
      c % vec != 0 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{x_strides[0], x_strides[1], x_strides[2], x_strides[3]};
  const Strides ss{skip_strides[0], skip_strides[1], skip_strides[2],
                   skip_strides[3]};
  const int nearest = mode == 0;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(vec, x, skip, out, n, h, w, c, oh, ow, xs, ss,
                          nearest, cs);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(vec, x, skip, out, n, h, w, c, oh, ow, xs,
                                  ss, nearest, cs);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* tlx_upsample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
