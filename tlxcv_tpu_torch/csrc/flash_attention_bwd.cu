// Flash attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// The gradient of csrc/flash_attention.cu's function,
//   out = softmax(q k^T * scale + bias) v,
// which replaces the Pallas TPU kernel tlxcv_tpu/ops/pallas/attention.py
// (`flash_attention` :108).  The TPU kernel has no VJP: the JAX package
// trains attention on its einsum path (tlxcv_tpu/nn/attention.py:23-31),
// whose gradient this computes from the forward's saved statistic.
// Inputs: q, o, dO [B, H, Sq, D] and k, v [B, H, Sk, D] through their
// element strides (ViT's q, k and v are views into the packed qkv
// projection, o and dO token-major), the head dim contiguous; bias null or
// f32 [1 or B*H, Sq, Sk]; lse f32 [B*H, Sq], written by the forward.
// Outputs: dq [B*H, Sq, D] and dk, dv [B*H, Sk, D] contiguous, in the
// inputs' dtype; delta f32 [B*H, Sq] is scratch.
//
// Arithmetic, the forward's and flash_attention_backward_plain's
// (ops/cuda/attention.py):
// - scores x = q.k * scale (+ bias, clamped at -0.7 FLT_MAX), key columns
//   at or past Sk and query rows at or past Sq excluded explicitly (no
//   zero-filled padding enters a sum);
// - P = exp(x - lse) in f32.  lse is the forward's m + log(l) in natural
//   units, not the log2 units the bf16 forward keeps its scores in: the
//   clamp value times log2(e) overflows f32.  A row whose every key the
//   bias masks has x = the clamp at each key and lse = the clamp (log(l)
//   vanishes against it); the forward averages v there, so P = 1/Sk;
// - delta = rowsum(dO * O) (kernel 1);
// - dV = P^T dO with P rounded to v's dtype, where the forward rounds it
//   before P.V; dP = dO V^T; dS = P (dP - delta), zero where the clamp
//   took the score (its gradient is 0 there); dK = scale dS^T Q
//   (kernel 2: one block a 64-key tile, looping over the query tiles);
//   dQ = scale dS K (kernel 3: one block a 64-row query tile, looping
//   over the key tiles).  Every sum is f32, each output written once by
//   one thread: no atomics, so two runs are bitwise equal.
//
// What bounds it: at ViT-B/16 b64 (BH = 768, S = 197, D = 64) the bytes
// of q, k, v, o, dO, dq, dk and dv (155 MB, 0.046 ms at 3.35 TB/s); at
// DETR-R50's encoder (S = 1050, D = 32) the operations.  bf16 runs the
// five products on the tensor cores (mma.sync m16n8k16 from shared
// memory, the S and dP accumulators reused in registers as the A operand
// of the next product; dS rounded to bf16 there, as P is); f32 runs them
// on the FMA units, since the tensor cores would round to TF32.  Neither
// uses TMA or wgmma yet: the forward's tiling is the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNeg = -0.7f * 3.402823466e38f;  // the forward's clamp
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;      // query rows or keys a tile
constexpr int kThreads = 256;  // 16 x 16 threads of 4 x 4 scores each

// Element strides of (batch, head, row) of q, k, v, o and dO.
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3];
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// ---------------------------------------------------------------- delta
// One warp a row: delta[bh, r] = sum_d dO[bh, r, d] * O[bh, r, d].
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ g,
                float* __restrict__ delta, long long rows, int Sq, int H,
                int D, Strides st) {
  const long long row = blockIdx.x * (long long)(kThreads / 32) +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long bh = row / Sq;
  const int r = static_cast<int>(row % Sq);
  const long long b = bh / H, h = bh % H;
  const T* orow = o + b * st.o[0] + h * st.o[1] + r * st.o[2];
  const T* grow = g + b * st.g[0] + h * st.g[1] + r * st.g[2];
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += ld(orow + d) * ld(grow + d);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// ------------------------------------------------- f32: the FMA units
template <int D>
struct Smem {
  static constexpr int LD = D + 1;       // padded rows: conflict-free columns
  static constexpr int PLD = kTile + 1;
  static constexpr int kFloats = 4 * kTile * LD + kTile * PLD + 2 * kTile;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// A tile of `kTile` rows from row `r0` of a (batch, head)'s rows into
// rows of LD floats; rows at or past `n` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long row_stride, int r0,
                                          int n) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int row = i / D, col = i % D, r = r0 + row;
    dst[row * LD + col] = r < n ? base[r * row_stride + col] : 0.f;
  }
}

// The 4 x 4 scores and dP of this thread: query rows 4 ty + a of sq/sdo,
// keys tx + 16 c of sk/sv.
template <int D>
__device__ __forceinline__ void products(const float* sq, const float* sdo,
                                         const float* sk, const float* sv,
                                         float (&s)[4][4], float (&dp)[4][4]) {
  constexpr int LD = D + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], ga[4], kc[4], vc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = sq[(4 * ty + a) * LD + d];
      ga[a] = sdo[(4 * ty + a) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kc[c] = sk[(tx + 16 * c) * LD + d];
      vc[c] = sv[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
        dp[a][c] = fmaf(ga[a], vc[c], dp[a][c]);
      }
  }
}

// P and dS of one score: query row gq, key gk (both in range).
template <bool kBias>
__device__ __forceinline__ void p_and_ds(float s, float dp, float lse,
                                         float delta, const float* brow,
                                         int gk, float scale, float inv_sk,
                                         float* p, float* ds) {
  if (kBias) {
    const float xr = fmaf(s, scale, brow[gk]);
    const float x = fmaxf(xr, kNeg);
    *p = lse == kNeg ? inv_sk : exp2f((x - lse) * kLog2e);
    *ds = xr >= kNeg ? *p * (dp - delta) : 0.f;
  } else {
    *p = exp2f((s * scale - lse) * kLog2e);
    *ds = *p * (dp - delta);
  }
}

// -------------------------------------------------------------- dK, dV
template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ bias, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int Sq, int Sk, int H, Strides st,
               long long bias_bh_stride, float scale) {
  using S = Smem<D>;
  constexpr int LD = S::LD, PLD = S::PLD, ND = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;               // [kTile][LD]
  float* sv = sk + kTile * LD;    // [kTile][LD]
  float* sq = sv + kTile * LD;    // [kTile][LD]
  float* sdo = sq + kTile * LD;   // [kTile][LD]
  // [kTile query rows][PLD]: P, then dS (kept in registers meanwhile);
  // dV is accumulated before dS overwrites P
  float* sp = sdo + kTile * LD;
  float* slse = sp + kTile * PLD;
  float* sdelta = slse + kTile;

  const int n_kt = (Sk + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * kTile;
  const int b = bh / H, h = bh % H;
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* gb = g + b * st.g[0] + h * st.g[1];
  const float* lb = lse + static_cast<long long>(bh) * Sq;
  const float* db = delta + static_cast<long long>(bh) * Sq;
  const float* bb = kBias ? bias + bh * bias_bh_stride : nullptr;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int jk = tid / 4, sub = tid % 4;  // accumulated key and dims
  const float inv_sk = 1.f / Sk;

  load_tile<D>(sk, k + b * st.k[0] + h * st.k[1], st.k[2], k0, Sk);
  load_tile<D>(sv, v + b * st.v[0] + h * st.v[1], st.v[2], k0, Sk);
  float dk_acc[ND], dv_acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kTile) {
    __syncthreads();  // the previous query tile is no longer read
    load_tile<D>(sq, qb, st.q[2], q0, Sq);
    load_tile<D>(sdo, gb, st.g[2], q0, Sq);
    if (tid < kTile) {
      const int r = q0 + tid;
      slse[tid] = r < Sq ? lb[r] : 0.f;
      sdelta[tid] = r < Sq ? db[r] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    products<D>(sq, sdo, sk, sv, s, dp);
    float ds[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * ty + a, gq = q0 + i;
      const float* brow =
          kBias ? bb + static_cast<long long>(min(gq, Sq - 1)) * Sk : nullptr;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c, gk = k0 + j;
        float p = 0.f, d = 0.f;
        if (gq < Sq && gk < Sk)
          p_and_ds<kBias>(s[a][c], dp[a][c], slse[i], sdelta[i], brow, gk,
                          scale, inv_sk, &p, &d);
        sp[i * PLD + j] = p;
        ds[a][c] = d;
      }
    }
    __syncthreads();
    // dV += P^T dO
    for (int i = 0; i < kTile; ++i) {
      const float pp = sp[i * PLD + jk];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd)
        dv_acc[dd] = fmaf(pp, sdo[i * LD + sub + 4 * dd], dv_acc[dd]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sp[(4 * ty + a) * PLD + tx + 16 * c] = ds[a][c];
    __syncthreads();
    // dK += dS^T Q (scaled once at the end)
    for (int i = 0; i < kTile; ++i) {
      const float d = sp[i * PLD + jk];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd)
        dk_acc[dd] = fmaf(d, sq[i * LD + sub + 4 * dd], dk_acc[dd]);
    }
  }
  const int gk = k0 + jk;
  if (gk < Sk) {
    const long long off = (static_cast<long long>(bh) * Sk + gk) * D + sub;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) {
      dk[off + 4 * dd] = dk_acc[dd] * scale;
      dv[off + 4 * dd] = dv_acc[dd];
    }
  }
}

// ------------------------------------------------------------------- dQ
template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ g,
             const float* __restrict__ bias, const float* __restrict__ lse,
             const float* __restrict__ delta, float* __restrict__ dq, int Sq,
             int Sk, int H, Strides st, long long bias_bh_stride,
             float scale) {
  using S = Smem<D>;
  constexpr int LD = S::LD, PLD = S::PLD, ND = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = sk + kTile * LD;
  float* sq = sv + kTile * LD;
  float* sdo = sq + kTile * LD;
  float* sds = sdo + kTile * LD;  // [kTile query rows][PLD]
  float* slse = sds + kTile * PLD;
  float* sdelta = slse + kTile;

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kTile;
  const int b = bh / H, h = bh % H;
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const float* bb = kBias ? bias + bh * bias_bh_stride : nullptr;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int iq = tid / 4, sub = tid % 4;  // accumulated query row and dims
  const float inv_sk = 1.f / Sk;

  load_tile<D>(sq, q + b * st.q[0] + h * st.q[1], st.q[2], q0, Sq);
  load_tile<D>(sdo, g + b * st.g[0] + h * st.g[1], st.g[2], q0, Sq);
  if (tid < kTile) {
    const int r = q0 + tid;
    slse[tid] = r < Sq ? lse[static_cast<long long>(bh) * Sq + r] : 0.f;
    sdelta[tid] = r < Sq ? delta[static_cast<long long>(bh) * Sq + r] : 0.f;
  }
  float dq_acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) dq_acc[i] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kTile) {
    __syncthreads();  // the previous key tile and dS are no longer read
    load_tile<D>(sk, kb, st.k[2], k0, Sk);
    load_tile<D>(sv, vb, st.v[2], k0, Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    products<D>(sq, sdo, sk, sv, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * ty + a, gq = q0 + i;
      const float* brow =
          kBias ? bb + static_cast<long long>(min(gq, Sq - 1)) * Sk : nullptr;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c, gk = k0 + j;
        float p = 0.f, d = 0.f;
        if (gq < Sq && gk < Sk)
          p_and_ds<kBias>(s[a][c], dp[a][c], slse[i], sdelta[i], brow, gk,
                          scale, inv_sk, &p, &d);
        sds[i * PLD + j] = d;
      }
    }
    __syncthreads();
    // dQ += dS K (scaled once at the end)
    for (int j = 0; j < kTile; ++j) {
      const float d = sds[iq * PLD + j];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd)
        dq_acc[dd] = fmaf(d, sk[j * LD + sub + 4 * dd], dq_acc[dd]);
    }
  }
  const int gq = q0 + iq;
  if (gq < Sq) {
    const long long off = (static_cast<long long>(bh) * Sq + gq) * D + sub;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) dq[off + 4 * dd] = dq_acc[dd] * scale;
  }
}

// ------------------------------------------- bf16: tensor cores (mma.sync)
// The five products on the tensor cores, m16n8k16 bf16 with f32 sums: four
// warps a block, each owning 16 rows of its 64 (keys in dk/dv, queries in
// dq), the inner loop over chunks of 32 rows of the other side.  Every
// operand is read from shared memory as bf16 pairs along the product's
// depth, so each tile the B side needs along the other axis is kept
// transposed too (Q and dO for dk/dv, K for dq).  The accumulator of S or
// dP is the A operand of the next product as it lies in registers (as in
// the forward's P): P rounded to bf16 as the forward rounds it, and dS
// rounded to bf16 for dK and dQ (the plain version keeps dS in f32; the
// difference stays within the bf16 bound).
constexpr int kTcThreads = 128;
constexpr int kTcRows = 64;   // rows a block owns
constexpr int kTcChunk = 32;  // rows of the other side an inner step

template <int D>
struct TcSmem {
  static constexpr int LD = D + 8;          // [row][d] tiles, bf16
  static constexpr int LDT = kTcChunk + 8;  // [d][chunk] tiles, bf16
  // dk/dv: K, V [64][LD]; Q, dO [32][LD]; Q^T, dO^T [D][LDT]; lse, delta
  static constexpr size_t kDkdv =
      (2 * kTcRows * LD + 2 * kTcChunk * LD + 2 * D * LDT) * 2 +
      2 * kTcChunk * sizeof(float);
  // dq: Q, dO [64][LD]; K, V [32][LD]; K^T [D][LDT]; lse, delta
  static constexpr size_t kDq =
      (2 * kTcRows * LD + 2 * kTcChunk * LD + D * LDT) * 2 +
      2 * kTcRows * sizeof(float);
};

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&t);
}

// d += a b, m16n8k16, bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// `rows` rows from row r0 of a (batch, head)'s rows into [rows][LD] (and,
// with `dst_t`, transposed into [D][LDT]), rows at or past n zero.
template <int D>
__device__ __forceinline__ void load_bf16(__nv_bfloat16* dst,
                                          __nv_bfloat16* dst_t,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int r0,
                                          int rows, int n) {
  constexpr int LD = TcSmem<D>::LD, LDT = TcSmem<D>::LDT;
  for (int i = threadIdx.x; i < rows * (D / 2); i += kTcThreads) {
    const int row = i / (D / 2), c = 2 * (i % (D / 2)), r = r0 + row;
    const uint32_t pair = r < n ? ld_pair(base + r * row_stride + c) : 0u;
    *reinterpret_cast<uint32_t*>(dst + row * LD + c) = pair;
    if (dst_t != nullptr) {
      const __nv_bfloat162 two = *reinterpret_cast<const __nv_bfloat162*>(
          &pair);
      dst_t[c * LDT + row] = two.x;
      dst_t[(c + 1) * LDT + row] = two.y;
    }
  }
}

// The A operand of rows (16 w + g, + 8) over depth [16 kk, 16 kk + 16) of
// a [row][LD] tile.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int row,
                                       int kk, int t) {
  const __nv_bfloat16* p = tile + row * LD + 16 * kk + 2 * t;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * LD);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * LD + 8);
}

// The B operand of columns n0 + g over depth [16 kk, +16): a tile stored
// [column][depth] with row stride `ld`.
__device__ __forceinline__ void mma_b(float (&d)[4], const uint32_t (&a)[4],
                                      const __nv_bfloat16* tile, int ld,
                                      int col, int kk, int t) {
  const __nv_bfloat16* p = tile + col * ld + 16 * kk + 2 * t;
  mma_bf16(d, a, ld_pair(p), ld_pair(p + 8));
}

// P and dS of this warp's 16 x 32 scores (4 n-tiles of m16n8: rows row0 +
// g (+ 8), columns col0 + 8 j + 2 t (+ 1)) packed as the A operands of the
// two k16 steps over those 32 columns.  The rows are queries in dq and
// keys in dk/dv.
template <bool kBias, bool kRowsAreQueries>
__device__ __forceinline__ void tc_p_ds(
    const float (&s)[4][4], const float (&dp)[4][4], const float* slse,
    const float* sdelta, const float* bb, int row0, int col0, int g, int t,
    int Sq, int Sk, float scale, float inv_sk, uint32_t (&pa)[2][4],
    uint32_t (&da)[2][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float p[4], d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + ((e & 2) ? 8 : 0);
      const int col = col0 + 8 * j + 2 * t + (e & 1);
      const int gq = kRowsAreQueries ? row : col;
      const int gk = kRowsAreQueries ? col : row;
      // the query's index into the statistics (``slse`` starts at this
      // warp's rows in dq, at the chunk's columns in dk/dv)
      const int lq = kRowsAreQueries ? g + ((e & 2) ? 8 : 0)
                                     : 8 * j + 2 * t + (e & 1);
      p[e] = 0.f;
      d[e] = 0.f;
      if (gq < Sq && gk < Sk) {
        const float lse = slse[lq], delta = sdelta[lq];
        if (kBias) {
          const float xr = fmaf(s[j][e], scale, bb[(long long)gq * Sk + gk]);
          const float x = fmaxf(xr, kNeg);
          p[e] = lse == kNeg ? inv_sk : exp2f((x - lse) * kLog2e);
          d[e] = xr >= kNeg ? p[e] * (dp[j][e] - delta) : 0.f;
        } else {
          p[e] = exp2f((s[j][e] * scale - lse) * kLog2e);
          d[e] = p[e] * (dp[j][e] - delta);
        }
      }
    }
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    da[j >> 1][(j & 1) * 2] = pack_bf16(d[0], d[1]);
    da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
  }
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkdv_tc(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ g,
                  const float* __restrict__ bias,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
                  Strides st, long long bias_bh_stride, float scale) {
  using S = TcSmem<D>;
  constexpr int LD = S::LD, LDT = S::LDT, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + kTcRows * LD;
  __nv_bfloat16* sq = sv + kTcRows * LD;
  __nv_bfloat16* sg = sq + kTcChunk * LD;
  __nv_bfloat16* sqt = sg + kTcChunk * LD;
  __nv_bfloat16* sgt = sqt + D * LDT;
  float* slse = reinterpret_cast<float*>(sgt + D * LDT);
  float* sdelta = slse + kTcChunk;

  const int n_kt = (Sk + kTcRows - 1) / kTcRows;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * kTcRows;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = q + b * st.q[0] + h * st.q[1];
  const __nv_bfloat16* gb = g + b * st.g[0] + h * st.g[1];
  const float* lb = lse + static_cast<long long>(bh) * Sq;
  const float* db = delta + static_cast<long long>(bh) * Sq;
  const float* bb = kBias ? bias + bh * bias_bh_stride : nullptr;
  const float inv_sk = 1.f / Sk;

  load_bf16<D>(sk, nullptr, k + b * st.k[0] + h * st.k[1], st.k[2], k0,
               kTcRows, Sk);
  load_bf16<D>(sv, nullptr, v + b * st.v[0] + h * st.v[1], st.v[2], k0,
               kTcRows, Sk);
  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kTcChunk) {
    __syncthreads();  // the previous chunk is no longer read
    load_bf16<D>(sq, sqt, qb, st.q[2], q0, kTcChunk, Sq);
    load_bf16<D>(sg, sgt, gb, st.g[2], q0, kTcChunk, Sq);
    if (threadIdx.x < kTcChunk) {
      const int r = q0 + threadIdx.x;
      slse[threadIdx.x] = r < Sq ? lb[r] : 0.f;
      sdelta[threadIdx.x] = r < Sq ? db[r] : 0.f;
    }
    __syncthreads();
    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 queries
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      frag_a<LD>(ak, sk, 16 * warp + gr, kk, t);
      frag_a<LD>(av, sv, 16 * warp + gr, kk, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_b(s[j], ak, sq, LD, 8 * j + gr, kk, t);
        mma_b(dp[j], av, sg, LD, 8 * j + gr, kk, t);
      }
    }
    uint32_t pa[2][4], da[2][4];
    tc_p_ds<kBias, false>(s, dp, slse, sdelta, bb, k0 + 16 * warp, q0, gr,
                          t, Sq, Sk, scale, inv_sk, pa, da);
    // dV += P^T dO and dK += dS^T Q over the chunk's 32 queries
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma_b(dv_acc[n], pa[ks], sgt, LDT, 8 * n + gr, ks, t);
        mma_b(dk_acc[n], da[ks], sqt, LDT, 8 * n + gr, ks, t);
      }
  }
  const int key0 = k0 + 16 * warp + gr;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key0 + 8 * half;
    if (key >= Sk) continue;
    const long long off = (static_cast<long long>(bh) * Sk + key) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) =
          __floats2bfloat162_rn(dk_acc[n][2 * half] * scale,
                                dk_acc[n][2 * half + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
          __floats2bfloat162_rn(dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
    }
  }
}

template <int D, bool kBias>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ g,
                const float* __restrict__ bias, const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
                Strides st, long long bias_bh_stride, float scale) {
  using S = TcSmem<D>;
  constexpr int LD = S::LD, LDT = S::LDT, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sg = sq + kTcRows * LD;
  __nv_bfloat16* sk = sg + kTcRows * LD;
  __nv_bfloat16* sv = sk + kTcChunk * LD;
  __nv_bfloat16* skt = sv + kTcChunk * LD;
  float* slse = reinterpret_cast<float*>(skt + D * LDT);
  float* sdelta = slse + kTcRows;

  const int n_qt = (Sq + kTcRows - 1) / kTcRows;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kTcRows;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, t = lane & 3;
  const __nv_bfloat16* kb = k + b * st.k[0] + h * st.k[1];
  const __nv_bfloat16* vb = v + b * st.v[0] + h * st.v[1];
  const float* bb = kBias ? bias + bh * bias_bh_stride : nullptr;
  const float inv_sk = 1.f / Sk;

  load_bf16<D>(sq, nullptr, q + b * st.q[0] + h * st.q[1], st.q[2], q0,
               kTcRows, Sq);
  load_bf16<D>(sg, nullptr, g + b * st.g[0] + h * st.g[1], st.g[2], q0,
               kTcRows, Sq);
  if (threadIdx.x < kTcRows) {
    const int r = q0 + threadIdx.x;
    const long long i = static_cast<long long>(bh) * Sq + r;
    slse[threadIdx.x] = r < Sq ? lse[i] : 0.f;
    sdelta[threadIdx.x] = r < Sq ? delta[i] : 0.f;
  }
  float dq_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kTcChunk) {
    __syncthreads();  // the previous chunk is no longer read
    load_bf16<D>(sk, skt, kb, st.k[2], k0, kTcChunk, Sk);
    load_bf16<D>(sv, nullptr, vb, st.v[2], k0, kTcChunk, Sk);
    __syncthreads();
    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 32 keys
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ag[4];
      frag_a<LD>(aq, sq, 16 * warp + gr, kk, t);
      frag_a<LD>(ag, sg, 16 * warp + gr, kk, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_b(s[j], aq, sk, LD, 8 * j + gr, kk, t);
        mma_b(dp[j], ag, sv, LD, 8 * j + gr, kk, t);
      }
    }
    uint32_t pa[2][4], da[2][4];
    tc_p_ds<kBias, true>(s, dp, slse + 16 * warp, sdelta + 16 * warp, bb,
                         q0 + 16 * warp, k0, gr, t, Sq, Sk, scale, inv_sk,
                         pa, da);
    // dQ += dS K over the chunk's 32 keys
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma_b(dq_acc[n], da[ks], skt, LDT, 8 * n + gr, ks, t);
  }
  const int row0 = q0 + 16 * warp + gr;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= Sq) continue;
    const long long off = (static_cast<long long>(bh) * Sq + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq + off + 8 * n) =
          __floats2bfloat162_rn(dq_acc[n][2 * half] * scale,
                                dq_acc[n][2 * half + 1] * scale);
  }
}

// --------------------------------------------------------------- launch
template <typename KvKernel, typename QKernel>
cudaError_t set_smem(KvKernel kv_kernel, size_t kv_smem, QKernel q_kernel,
                     size_t q_smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
}

// dk/dv then dq, each on its own grid of blocks of `rows` rows.
template <typename KvKernel, typename QKernel, typename T>
cudaError_t launch_pair(KvKernel kv_kernel, QKernel q_kernel, int threads,
                        int rows, size_t kv_smem, size_t q_smem, const T* q,
                        const T* k, const T* v, const T* g, const float* bias,
                        const float* lse, const float* delta, T* dq, T* dk,
                        T* dv, int bh, int sq, int sk, int heads,
                        const Strides& st, long long bias_bh_stride,
                        float scale, cudaStream_t stream) {
  const long long kv_blocks = (long long)bh * ((sk + rows - 1) / rows);
  const long long q_blocks = (long long)bh * ((sq + rows - 1) / rows);
  if (kv_blocks >= (1ll << 31) || q_blocks >= (1ll << 31))
    return cudaErrorInvalidValue;
  kv_kernel<<<(unsigned)kv_blocks, threads, kv_smem, stream>>>(
      q, k, v, g, bias, lse, delta, dk, dv, sq, sk, heads, st,
      bias_bh_stride, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  q_kernel<<<(unsigned)q_blocks, threads, q_smem, stream>>>(
      q, k, v, g, bias, lse, delta, dq, sq, sk, heads, st, bias_bh_stride,
      scale);
  return cudaGetLastError();
}

template <int D, typename T, bool kBias>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* g, const float* bias, const float* lse,
                         const float* delta, void* dq, void* dk, void* dv,
                         int bh, int sq, int sk, int heads, const Strides& st,
                         long long bias_bh_stride, float scale,
                         cudaStream_t stream) {
  // the tensor-core kernels for bf16, the FMA kernels for f32
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static const cudaError_t err =  // once per process and variant
        set_smem(flash_bwd_dkdv_tc<D, kBias>, TcSmem<D>::kDkdv,
                 flash_bwd_dq_tc<D, kBias>, TcSmem<D>::kDq);
    if (err != cudaSuccess) return err;
    return launch_pair(flash_bwd_dkdv_tc<D, kBias>, flash_bwd_dq_tc<D, kBias>,
                       kTcThreads, kTcRows, TcSmem<D>::kDkdv, TcSmem<D>::kDq,
                       qt, kt, vt, gt, bias, lse, delta, static_cast<T*>(dq),
                       static_cast<T*>(dk), static_cast<T*>(dv), bh, sq, sk,
                       heads, st, bias_bh_stride, scale, stream);
  } else {
    static const cudaError_t err =
        set_smem(flash_bwd_dkdv<D, kBias>, Smem<D>::kBytes,
                 flash_bwd_dq<D, kBias>, Smem<D>::kBytes);
    if (err != cudaSuccess) return err;
    return launch_pair(flash_bwd_dkdv<D, kBias>, flash_bwd_dq<D, kBias>,
                       kThreads, kTile, Smem<D>::kBytes, Smem<D>::kBytes, qt,
                       kt, vt, gt, bias, lse, delta, static_cast<T*>(dq),
                       static_cast<T*>(dk), static_cast<T*>(dv), bh, sq, sk,
                       heads, st, bias_bh_stride, scale, stream);
  }
}

template <int D, typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* o, const void* g, const float* bias,
                     const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int bh, int sq, int sk, int heads,
                     const Strides& st, long long bias_bh_stride, float scale,
                     cudaStream_t stream) {
  const long long rows = (long long)bh * sq;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  flash_bwd_delta<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(g), delta, rows, sq,
      heads, D, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (bias != nullptr)
    return launch_typed<D, T, true>(q, k, v, g, bias, lse, delta, dq, dk, dv,
                                    bh, sq, sk, heads, st, bias_bh_stride,
                                    scale, stream);
  return launch_typed<D, T, false>(q, k, v, g, bias, lse, delta, dq, dk, dv,
                                   bh, sq, sk, heads, st, bias_bh_stride,
                                   scale, stream);
}

}  // namespace

// q, o, dout: [batch, heads, sq, d] and k, v: [batch, heads, sk, d], given
// by element strides (15 values: batch, head and row strides of q, k, v,
// o and dout in turn), the head dim contiguous; all f32 or all bf16
// (is_bf16).  bias: null or contiguous f32 [1 or batch*heads, sq, sk]
// (bias_per_bh).  lse: the forward's f32 [batch*heads, sq]; delta: f32
// scratch of the same shape.  dq: contiguous [batch*heads, sq, d]; dk, dv:
// contiguous [batch*heads, sk, d], in the inputs' dtype.  Launches three
// kernels on `stream` without synchronising; returns the first
// cudaError_t of the launches.
extern "C" int tlx_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* bias, const void* lse, void* delta,
    void* dq, void* dk, void* dv, int batch, int heads, int sq, int sk,
    int d, const long long* strides, int bias_per_bh, float scale,
    int is_bf16, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
    st.g[i] = strides[12 + i];
  }
  const float* b = static_cast<const float*>(bias);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const long long bs = bias_per_bh ? (long long)sq * sk : 0;
  const int bh = batch * heads;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define TLX_LAUNCH(D, T)                                                    \
  return launch_d<D, T>(q, k, v, o, dout, b, l, dl, dq, dk, dv, bh, sq, sk, \
                        heads, st, bs, scale, cs)
  if (is_bf16) {
    switch (d) {
      case 32: TLX_LAUNCH(32, __nv_bfloat16);
      case 64: TLX_LAUNCH(64, __nv_bfloat16);
      case 96: TLX_LAUNCH(96, __nv_bfloat16);
      case 128: TLX_LAUNCH(128, __nv_bfloat16);
    }
  } else {
    switch (d) {
      case 32: TLX_LAUNCH(32, float);
      case 64: TLX_LAUNCH(64, float);
      case 96: TLX_LAUNCH(96, float);
      case 128: TLX_LAUNCH(128, float);
    }
  }
#undef TLX_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tlx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
