// 2x half-pixel bilinear upsample and its VJP, for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernels of tlxcv_tpu/ops/pallas/upsample.py on
// their 2x path: `_apply_sep_matrices` (pallas_call :164) as called by
// `upsample2x_fused` (:303) and its VJP `_fused_2x_bwd` (:288), and the
// shift-and-interleave `_upsample2x_kernel` (:338, pallas_call :376) behind
// `upsample2x_bilinear` (:372), the same function.  The TPU runs the first
// as two dense MXU matmuls per image against the [2H, H] and [2W, W]
// matrices of `_resize_matrix`.  Here every tap is known from the output
// index alone, so no matrix is read.
//
// Contract: x [N, H, W, C] (forward) or g [N, 2H, 2W, C] (VJP), f32 or
// bf16, any element strides (a stride-0 gradient from `.sum()` included;
// the vector paths need the channels contiguous); out [N, 2H, 2W, C] or dx
// [N, H, W, C], contiguous, the input's dtype.  Each output equals the
// generic separable resize (csrc/sep_resize.cu, and `sep_resize_plain`) on
// the taps of `resize_matrix(2H, H, "bilinear")` and the same for W, or on
// their transposes: rows first, then columns, the taps in ascending source
// order, every sum started at 0 and taken in f32 with IEEE multiply and add
// (no fused multiply-add), rounded once to the output dtype.  The taps,
// checked against that matrix once per size on the host:
//   forward, output row 2k:   .25 x[k-1] + .75 x[k]   (row 0: x[0])
//            output row 2k+1: .75 x[k] + .25 x[k+1]   (row 2H-1: x[H-1])
//   VJP, dx row k: .25 g[2k-1] (k > 0), then g[2k] by (k == 0 ? 1 : .75),
//                  g[2k+1] by (k == H - 1 ? 1 : .75), .25 g[2k+2] (k < H - 1)
// and the same along W.
//
// What bounds it: bytes.  The input is read once and the output written
// once: at [8, 80, 80, 256] bf16 26.2 MB in and 104.9 MB out (forward), or
// the reverse (VJP), 0.0391 ms at 3.35 TB/s; a few f32 operations per
// element are far below the compute rate.
//
// Design.  The vertical sum for one (output row, input column) has the same
// bits whichever output column reads it, so a thread computes it once and
// uses it for both output columns it feeds (forward), or carries it from
// one output row to the next (VJP).  A thread owns one vector of channels
// (16 bytes: 8 bf16 or 4 f32 when C, the strides and the pointers allow,
// else narrower) at one column, for a band of kRows input rows (dx rows for
// the VJP); neighbouring threads take neighbouring channels, then
// neighbouring columns, so loads and stores coalesce.
// - Forward: the thread walks down the band with the upper row of a pair in
//   registers, each row at its three columns j-1, j, j+1.  A pair of rows
//   (m, m+1) gives output rows 2m+1 and 2m+2, each of them output columns
//   2j and 2j+1.
// - VJP: the thread walks down its dx rows with four g columns 2l-1 .. 2l+2
//   and carries, for each, the partial vertical sum over g rows 2k-1 and 2k
//   into the next dx row.
// - Reads.  Where the input is dense with 16-byte vectors (as autograd's
//   gradients and the callers' activations are), its rows come into shared
//   memory by bulk async copies, several steps of a block's rows in flight
//   (the bulk routes, below): read through registers, the VJP, whose reads
//   are four fifths of its bytes, kept too few bytes in flight (by Little's
//   law an SM must hold some 25-50 KB of reads in flight to stream at 3.35
//   TB/s) and took 0.079 ms at [8, 80, 80, 256] bf16 on an H100, twice its
//   bound; through bulk copies 0.054.  Any other layout takes the pointer
//   routes, which read device memory directly; each input vector is read by
//   the three or four threads whose columns it feeds, and the repeats hit
//   L1/L2 (the generic kernel fetched each input vector 16 times).
// - Stores are streaming (st.global.cs, evict-first): the output is not read
//   again here and would otherwise push the input out of the L2.  Staging
//   the forward's rows in shared memory for bulk stores was slower.
// - Integer arithmetic is 32-bit: offsets inside one image (the host checks
//   they fit), 64-bit only for an image's base.  A grid-stride loop over
//   blocks of (image, band, columns x channel vectors), the grid sized to
//   fill the SMs at the kernel's occupancy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // input rows (forward) or dx rows (VJP) a band
constexpr int kStages = 4;  // the bulk routes: steps of input rows in flight

struct Strides {
  long long n;  // between images
  int h, w, c;  // inside one image (the host checks the span fits in 31 bits)
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

// Rounds once to T and stores with the evict-first hint (st.global.cs).
template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&f)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int k = 0; k < VEC; ++k) pk.v[k] = from_f<T>(f[k]);
  constexpr int kBytes = sizeof(T) * VEC;
  if constexpr (kBytes == 16) {
    __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&pk));
  } else if constexpr (kBytes == 8) {
    __stcs(reinterpret_cast<uint2*>(p), *reinterpret_cast<const uint2*>(&pk));
  } else if constexpr (kBytes == 4) {
    __stcs(reinterpret_cast<unsigned*>(p),
           *reinterpret_cast<const unsigned*>(&pk));
  } else {
    __stcs(reinterpret_cast<unsigned short*>(p),
           *reinterpret_cast<const unsigned short*>(&pk));
  }
}

// acc = 0 + v * w, then acc += v * w: the plain version's IEEE operations.
template <int VEC>
__device__ __forceinline__ void first(float (&acc)[VEC], const float (&v)[VEC],
                                      float w) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(0.0f, __fmul_rn(v[k], w));
}
template <int VEC>
__device__ __forceinline__ void add(float (&acc)[VEC], const float (&v)[VEC],
                                    float w) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(v[k], w));
}

// The pointer routes: which work item a thread owns in block `b` of the
// grid-stride loop: image, band of rows, and (column, channel offset), or
// false past the end of the row.
struct Item {
  int img, k0, col, ch;
};

__device__ __forceinline__ bool item(int b, int cols, int rows, int c,
                                     int vec, Item& it) {
  const int cv = c / vec;
  const int per_row = cols * cv;
  const int xblocks = (per_row + kThreads - 1) / kThreads;
  const int bands = (rows + kRows - 1) / kRows;
  const int xb = b % xblocks;
  const int rest = b / xblocks;
  it.k0 = (rest % bands) * kRows;
  it.img = rest / bands;
  const int t = xb * kThreads + static_cast<int>(threadIdx.x);
  if (t >= per_row) return false;
  it.col = t / cv;
  it.ch = (t - it.col * cv) * vec;
  return true;
}

// Output row `orow` (columns 2j and 2j + 1) from the vertical sums v of
// input columns j-1, j, j+1.
template <typename T, int VEC>
__device__ __forceinline__ void emit(T* orow, const float (&v)[3][VEC], int j,
                                     int w, int c) {
  float o[VEC];
  if (j == 0) {
    first(o, v[1], 1.0f);
  } else {
    first(o, v[0], 0.25f);
    add(o, v[1], 0.75f);
  }
  store<T, VEC>(orow + 2 * j * c, o);
  if (j == w - 1) {
    first(o, v[1], 1.0f);
  } else {
    first(o, v[1], 0.75f);
    add(o, v[2], 0.25f);
  }
  store<T, VEC>(orow + (2 * j + 1) * c, o);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* xi, int row,
                                         const int (&col)[3], int sh,
                                         float (&r)[3][VEC]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) load<T, VEC>(xi + row * sh + col[i], r[i]);
}

// The forward's pointer route (any strides).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
upsample2x_kernel(const T* __restrict__ x, T* __restrict__ out, int blocks,
                  int h, int w, int c, Strides xs) {
  const int ow = 2 * w;
  for (int b = blockIdx.x; b < blocks; b += gridDim.x) {
    Item it;
    if (!item(b, w, h, c, VEC, it)) continue;
    const int j = it.col, k0 = it.k0, k1 = min(k0 + kRows, h);
    const T* xi = x + it.img * xs.n + it.ch * xs.c;
    T* oi = out + static_cast<long long>(it.img) * (2 * h) * ow * c + it.ch;
    const int col[3] = {max(j - 1, 0) * xs.w, j * xs.w,
                        min(j + 1, w - 1) * xs.w};
    float lo[3][VEC], hi[3][VEC], v[3][VEC];
    const int m0 = max(k0 - 1, 0);
    load_row<T, VEC>(xi, m0, col, xs.h, lo);
    if (k0 == 0) {  // output row 0: x[0] alone
#pragma unroll
      for (int i = 0; i < 3; ++i) first(v[i], lo[i], 1.0f);
      emit<T, VEC>(oi, v, j, w, c);
    }
#pragma unroll
    for (int q = 0; q <= kRows; ++q) {  // the input row pair (m, m + 1)
      const int m = m0 + q;
      if (m >= k1) break;
      const bool last = m + 1 >= h;
      load_row<T, VEC>(xi, last ? m : m + 1, col, xs.h, hi);
      if (m >= k0) {  // output row 2m + 1
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (last) {
            first(v[i], lo[i], 1.0f);
          } else {
            first(v[i], lo[i], 0.75f);
            add(v[i], hi[i], 0.25f);
          }
        }
        emit<T, VEC>(oi + (2 * m + 1) * ow * c, v, j, w, c);
      }
      if (m + 1 < k1) {  // output row 2m + 2
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          first(v[i], lo[i], 0.25f);
          add(v[i], hi[i], 0.75f);
        }
        emit<T, VEC>(oi + (2 * m + 2) * ow * c, v, j, w, c);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < VEC; ++k) lo[i][k] = hi[i][k];
    }
  }
}

// dx row k's sum of g column i over g rows 2k+1 and 2k+2 (the last, for
// k < H - 1), added to p (rows 2k-1 and 2k so far); next gets dx row k+1's
// start from the same two rows.
template <int VEC>
__device__ __forceinline__ void vertical(float (&p)[VEC], float (&next)[VEC],
                                         const float (&a)[VEC],
                                         const float (&bb)[VEC], bool last) {
  add(p, a, last ? 1.0f : 0.75f);
  if (!last) {
    add(p, bb, 0.25f);
    first(next, a, 0.25f);
    add(next, bb, 0.75f);
  }
}

// dx column l from the vertical sums of g columns 2l-1 .. 2l+2, in
// ascending order.
template <int VEC>
__device__ __forceinline__ void horizontal(float (&o)[VEC],
                                           const float (&p)[4][VEC], int l,
                                           int w) {
  if (l > 0) {
    first(o, p[0], 0.25f);
    add(o, p[1], 0.75f);
  } else {
    first(o, p[1], 1.0f);
  }
  add(o, p[2], l == w - 1 ? 1.0f : 0.75f);
  if (l < w - 1) add(o, p[3], 0.25f);
}

// The VJP's pointer route (any strides): dx[k, l] from g rows 2k-1 .. 2k+2
// and columns 2l-1 .. 2l+2 (clamped), read from device memory.  p[i]
// carries the vertical sum of g column i for the current dx row (g rows
// 2k-1 and 2k) into the next.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
upsample2x_vjp_kernel(const T* __restrict__ g, T* __restrict__ dx,
                      int blocks, int h, int w, int c, Strides gs) {
  for (int b = blockIdx.x; b < blocks; b += gridDim.x) {
    Item it;
    if (!item(b, w, h, c, VEC, it)) continue;
    const int l = it.col, k0 = it.k0, k1 = min(k0 + kRows, h);
    const T* gi = g + it.img * gs.n + it.ch * gs.c;
    T* di = dx + static_cast<long long>(it.img) * h * w * c + it.ch;
    const int col[4] = {max(2 * l - 1, 0) * gs.w, 2 * l * gs.w,
                        (2 * l + 1) * gs.w, min(2 * l + 2, 2 * w - 1) * gs.w};
    float p[4][VEC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a[VEC], bb[VEC];
      if (k0 == 0) {  // dx row 0 starts at g row 0, weight 1
        load<T, VEC>(gi + col[i], a);
        first(p[i], a, 1.0f);
      } else {
        load<T, VEC>(gi + (2 * k0 - 1) * gs.h + col[i], a);
        load<T, VEC>(gi + 2 * k0 * gs.h + col[i], bb);
        first(p[i], a, 0.25f);
        add(p[i], bb, 0.75f);
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int k = k0 + q;
      if (k >= k1) break;
      const bool last = k == h - 1;
      float next[4][VEC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a[VEC], bb[VEC];
        load<T, VEC>(gi + (2 * k + 1) * gs.h + col[i], a);
        if (!last) load<T, VEC>(gi + (2 * k + 2) * gs.h + col[i], bb);
        vertical(p[i], next[i], a, bb, last);
      }
      float o[VEC];
      horizontal(o, p, l, w);
      store<T, VEC>(di + (k * w + l) * c, o);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) p[i][e] = next[i][e];
    }
  }
}

// ----------------------------------------------------------- bulk routes
// Where the input is dense with 16-byte vectors of channels (C * sizeof(T)
// a multiple of 16, cv = C / VEC dividing kThreads, the base 16-byte
// aligned), a block owns (image, band of kRows rows, kThreads / cv whole
// columns from c0: x columns forward, dx columns for the VJP), and its
// input rows arrive in shared memory by bulk async copies, one copy per
// input row of the block's input columns (first = c0 - 1 forward, 2 c0 - 1
// for the VJP, to the last its columns read, clamped to the image: a
// column past the edge is not copied, and the weights there skip it).  A
// stage holds one step's rows; thread 0 keeps kStages steps in flight,
// walking the block's whole grid-stride sequence ahead of the consumers,
// and refills a slot after the barrier that ends its step.  The threads
// then sum as the pointer routes do, reading their columns from shared
// memory.

// The input rows of step s of a band from k0.  Forward: one x row a step,
// rows max(k0-1, 0) .. min(k1, H-1).  VJP: rows 2k0-1 and 2k0 (row 0 alone
// for k0 = 0), then 2k+1 and 2k+2 (2k+1 alone for k = H-1) for each dx row
// k of the band.
template <bool kVjp>
__device__ __forceinline__ int bulk_steps(int k0, int h) {
  const int k1 = min(k0 + kRows, h);
  return kVjp ? 1 + k1 - k0 : min(k1, h - 1) - max(k0 - 1, 0) + 1;
}

template <bool kVjp>
__device__ __forceinline__ void bulk_rows(int s, int k0, int h, int& r0,
                                          int& nrows) {
  if (!kVjp) {
    r0 = max(k0 - 1, 0) + s;
    nrows = 1;
  } else if (s == 0) {
    r0 = k0 == 0 ? 0 : 2 * k0 - 1;
    nrows = k0 == 0 ? 1 : 2;
  } else {
    const int k = k0 + s - 1;
    r0 = 2 * k + 1;
    nrows = k == h - 1 ? 1 : 2;
  }
}

template <typename T, bool kVjp>
__global__ void __launch_bounds__(kThreads)
upsample2x_bulk_kernel(const T* __restrict__ in, T* __restrict__ out,
                       int blocks, int h, int w, int c, long long sn) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kScale = kVjp ? 2 : 1;  // input columns per owned column
  constexpr int kStepRows = kVjp ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = tlx::smem_u32(smem);
  T* ring = reinterpret_cast<T*>(smem + 128);  // [kStages][kStepRows][span][c]
  const int t = threadIdx.x;
  const int cv = c / VEC;
  const int cols = kThreads / cv;           // columns a block owns
  const int span = kScale * cols + 2;       // input columns a stage row holds
  const int stage = kStepRows * span * c;   // elements
  const int in_w = kScale * w;
  const int in_row = in_w * c;              // elements of one input row
  const int xblocks = (w + cols - 1) / cols;
  const int bands = (h + kRows - 1) / kRows;

  auto decode = [&](int b, int& img, int& k0, int& c0) {
    c0 = (b % xblocks) * cols;
    const int rest = b / xblocks;
    k0 = (rest % bands) * kRows;
    img = rest / bands;
  };
  auto issue = [&](int b, int s, int slot) {  // thread 0
    int img, k0, c0, r0, nrows;
    decode(b, img, k0, c0);
    bulk_rows<kVjp>(s, k0, h, r0, nrows);
    const int first = kScale * c0 - 1;
    const int lo = max(first, 0), hi = min(first + span - 1, in_w - 1);
    const uint32_t bytes = static_cast<uint32_t>((hi - lo + 1) * c * sizeof(T));
    const uint32_t bar = bars + 8 * slot;
    tlx::mbar_expect_tx(bar, nrows * bytes);
    const T* src = in + img * sn + r0 * in_row + lo * c;
    T* dst = ring + slot * stage + (lo - first) * c;
    for (int r = 0; r < nrows; ++r)
      tlx::bulk_load(tlx::smem_u32(dst + r * span * c), src + r * in_row,
                     bytes, bar);
  };

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) tlx::mbar_init(bars + 8 * s, 1);
    tlx::fence_barrier_init();
  }
  __syncthreads();
  int pb = blockIdx.x, ps = 0;  // thread 0: the next step to issue
  auto advance = [&]() {
    int img, k0, c0;
    decode(pb, img, k0, c0);
    if (++ps == bulk_steps<kVjp>(k0, h)) {
      ps = 0;
      pb += gridDim.x;
    }
  };
  if (t == 0) {
    for (int s = 0; s < kStages && pb < blocks; ++s) {
      issue(pb, ps, s);
      advance();
    }
  }
  int n = 0;  // steps consumed
  for (int b = blockIdx.x; b < blocks; b += gridDim.x) {
    int img, k0, c0;
    decode(b, img, k0, c0);
    const int k1 = min(k0 + kRows, h);
    const int col = c0 + t / cv, ch = (t % cv) * VEC;
    const bool valid = col < w;
    const int steps = bulk_steps<kVjp>(k0, h);
    // forward: out rows, x row `lo` (the pair's upper row) in registers
    T* oi = out + static_cast<long long>(img) * (2 * h) * (2 * w) * c + ch;
    float lo[3][VEC];
    // VJP: dx rows, the vertical sums p of g columns 2l-1 .. 2l+2
    T* di = out + static_cast<long long>(img) * h * w * c + ch;
    float p[4][VEC];
    for (int s = 0; s < steps; ++s, ++n) {
      const int slot = n % kStages;
      tlx::mbar_wait(bars + 8 * slot, static_cast<uint32_t>((n / kStages) & 1));
      // input column kScale * col - 1 + i sits at stage column
      // kScale * (col - c0) + i
      const T* r0 = ring + slot * stage + (kScale * (col - c0)) * c + ch;
      if constexpr (kVjp) {
        const T* r1 = r0 + span * c;
        if (s == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float a[VEC], bb[VEC];
            load<T, VEC>(r0 + i * c, a);
            if (k0 == 0) {  // dx row 0 starts at g row 0, weight 1
              first(p[i], a, 1.0f);
            } else {
              load<T, VEC>(r1 + i * c, bb);
              first(p[i], a, 0.25f);
              add(p[i], bb, 0.75f);
            }
          }
        } else {
          const int k = k0 + s - 1;
          const bool last = k == h - 1;
          float next[4][VEC];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float a[VEC], bb[VEC];
            load<T, VEC>(r0 + i * c, a);
            if (!last) load<T, VEC>(r1 + i * c, bb);
            vertical(p[i], next[i], a, bb, last);
          }
          float o[VEC];
          horizontal(o, p, col, w);
          if (valid) store<T, VEC>(di + (k * w + col) * c, o);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e) p[i][e] = next[i][e];
        }
      } else {
        float hi[3][VEC], v[3][VEC];
#pragma unroll
        for (int i = 0; i < 3; ++i) load<T, VEC>(r0 + i * c, hi[i]);
        if (s == 0) {
          if (k0 == 0 && valid) {  // output row 0: x[0] alone
#pragma unroll
            for (int i = 0; i < 3; ++i) first(v[i], hi[i], 1.0f);
            emit<T, VEC>(oi, v, col, w, c);
          }
        } else {  // the input row pair (m, m + 1), m + 1 < H
          const int m = max(k0 - 1, 0) + s - 1;
          if (m >= k0 && valid) {  // output row 2m + 1
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              first(v[i], lo[i], 0.75f);
              add(v[i], hi[i], 0.25f);
            }
            emit<T, VEC>(oi + (2 * m + 1) * (2 * w) * c, v, col, w, c);
          }
          if (m + 1 < k1 && valid) {  // output row 2m + 2
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              first(v[i], lo[i], 0.25f);
              add(v[i], hi[i], 0.75f);
            }
            emit<T, VEC>(oi + (2 * m + 2) * (2 * w) * c, v, col, w, c);
          }
        }
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e) lo[i][e] = hi[i][e];
      }
      __syncthreads();  // every thread has read the slot: refill it
      if (t == 0 && pb < blocks) {
        tlx::fence_proxy_async();
        issue(pb, ps, slot);
        advance();
      }
    }
    if constexpr (!kVjp) {
      if (k1 == h && valid) {  // output row 2H - 1: x[H-1] alone
        float v[3][VEC];
#pragma unroll
        for (int i = 0; i < 3; ++i) first(v[i], lo[i], 1.0f);
        emit<T, VEC>(oi + (2 * h - 1) * (2 * w) * c, v, col, w, c);
      }
    }
  }
}

template <typename T, bool kVjp>
cudaError_t launch_bulk(const void* in, void* out, int n, int h, int w, int c,
                        long long sn, cudaStream_t stream) {
  const int cols = kThreads / (c * static_cast<int>(sizeof(T)) / 16);
  const long long blocks = static_cast<long long>(n) *
                           ((h + kRows - 1) / kRows) * ((w + cols - 1) / cols);
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const size_t smem = 128 + static_cast<size_t>(kStages) * (kVjp ? 2 : 1) *
                                ((kVjp ? 2 : 1) * cols + 2) * c * sizeof(T);
  auto kernel = upsample2x_bulk_kernel<T, kVjp>;
  static size_t allowed = 0, occ_smem = 0;  // per instantiation
  static int occ = 0;
  cudaError_t err = cudaSuccess;
  if (smem > allowed) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  if (smem != occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    occ_smem = smem;
  }
  const long long cap = static_cast<long long>(tlx::sm_count()) * occ;
  const int grid = static_cast<int>(blocks < cap ? blocks : cap);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(in),
                                           static_cast<T*>(out),
                                           static_cast<int>(blocks), h, w, c,
                                           sn);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch(bool vjp, const void* in, void* out, int n, int h, int w,
                   int c, Strides s, cudaStream_t stream) {
  const long long per_row = static_cast<long long>(w) * (c / VEC);
  const long long blocks = static_cast<long long>(n) *
                           ((h + kRows - 1) / kRows) *
                           ((per_row + kThreads - 1) / kThreads);
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  auto kernel = vjp ? upsample2x_vjp_kernel<T, VEC> : upsample2x_kernel<T, VEC>;
  static int occupancy[2] = {0, 0};  // blocks an SM holds, per kernel
  int& occ = occupancy[vjp ? 1 : 0];
  if (occ == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  const long long cap = static_cast<long long>(tlx::sm_count()) * occ;
  const int grid = static_cast<int>(blocks < cap ? blocks : cap);
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(in),
                                        static_cast<T*>(out),
                                        static_cast<int>(blocks), h, w, c, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int vec, bool vjp, const void* in, void* out, int n,
                     int h, int w, int c, Strides s, cudaStream_t stream) {
  switch (vec) {
    case 1:
      return launch<T, 1>(vjp, in, out, n, h, w, c, s, stream);
    case 2:
      return launch<T, 2>(vjp, in, out, n, h, w, c, s, stream);
    case 4:
      return launch<T, 4>(vjp, in, out, n, h, w, c, s, stream);
    case 8:  // 16 bytes of bf16
      if constexpr (sizeof(T) == 2)
        return launch<T, 8>(vjp, in, out, n, h, w, c, s, stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

int run(bool vjp, const void* in, void* out, int n, int h, int w, int c,
        const long long* strides, int dtype, int vec, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || vec <= 0 || c % vec != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides s{strides[0], static_cast<int>(strides[1]),
                  static_cast<int>(strides[2]), static_cast<int>(strides[3])};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int elt = dtype == 0 ? 4 : 2;
  // the bulk routes: the input dense with 16-byte vectors (the wrapper's
  // vec says the pointer and every stride are multiples of 16 bytes)
  if (vec * elt == 16 && s.c == 1 && s.w == c &&
      s.h == (vjp ? 2 : 1) * w * c && kThreads % (c / vec) == 0) {
    cudaError_t err;
    if (dtype == 0)
      err = vjp ? launch_bulk<float, true>(in, out, n, h, w, c, s.n, cs)
                : launch_bulk<float, false>(in, out, n, h, w, c, s.n, cs);
    else
      err = vjp ? launch_bulk<__nv_bfloat16, true>(in, out, n, h, w, c, s.n, cs)
                : launch_bulk<__nv_bfloat16, false>(in, out, n, h, w, c, s.n,
                                                    cs);
    return static_cast<int>(err);
  }
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(vec, vjp, in, out, n, h, w, c, s, cs)
          : dispatch<__nv_bfloat16>(vec, vjp, in, out, n, h, w, c, s, cs);
  return static_cast<int>(err);
}

}  // namespace

// x [n, h, w, c] -> out [n, 2h, 2w, c].  x_strides: four element strides
// (n, h, w, c), the last three small enough that every offset inside one
// image fits in 31 bits, as out's image does.  dtype 0 f32, 1 bf16; vec
// channels per thread (C, the strides and the pointers must allow it).
// Returns a cudaError_t.
extern "C" int tlx_upsample2x(const void* x, void* out, int n, int h, int w,
                              int c, const long long* x_strides, int dtype,
                              int vec, void* stream) {
  return run(false, x, out, n, h, w, c, x_strides, dtype, vec, stream);
}

// g [n, 2h, 2w, c] -> dx [n, h, w, c]; the rest as tlx_upsample2x.
extern "C" int tlx_upsample2x_vjp(const void* g, void* dx, int n, int h,
                                  int w, int c, const long long* g_strides,
                                  int dtype, int vec, void* stream) {
  return run(true, g, dx, n, h, w, c, g_strides, dtype, vec, stream);
}

extern "C" const char* tlx_upsample2x_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
