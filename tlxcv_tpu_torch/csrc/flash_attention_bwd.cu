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
// - delta = rowsum(dO * O);
// - dV = P^T dO with P rounded to v's dtype, where the forward rounds it
//   before P.V; dP = dO V^T; dS = P (dP - delta), zero where the clamp
//   took the score (its gradient is 0 there); dK = scale dS^T Q and dQ =
//   scale dS K, with dS rounded to bf16 as their A operand in bf16 (the
//   plain version keeps dS in f32; the difference stays within the bf16
//   bound); in f32 every product is split TF32 (flash_attention.cuh),
//   within about 2^-20 of an f32 product.  Every sum is f32, each output
//   written once by one thread: no atomics, so two runs are bitwise equal.
//
// What bounds it: at ViT-B/16 b64 (BH = 768, S = 197, D = 64) the bytes
// of q, k, v, o, dO, dq, dk and dv (155 MB, 0.046 ms at 3.35 TB/s); at
// DETR-R50's encoder (S = 1050, D = 32) the five products (0.011 ms at
// the bf16 peak); its decoder grids (S = 100) by bytes.  At S = 197 the
// 64-row tiles pad each head to 256 rows (a wgmma takes 64) and a block
// sees only four tiles of the other side, so its prologue (the resident
// tiles' loads) and epilogue are not hidden behind a long loop, and the
// exponentials (P in both kernels: 2 x 256^2 a head) load the special-
// function unit: the kernels lean on several blocks an SM to overlap
// them.  On the H100 (700 W) the design measured 0.167 ms at ViT's grid
// (3.6x the bound), 0.09 ms at DETR's encoder.
//
// bf16 design: two warp-specialised kernels on the forward's tiling, each
// block one consumer warpgroup of 64 rows (wgmma's M) and one producer
// warp whose thread 0 keeps TMA loads in flight through a 2-stage
// full/empty mbarrier ring (4D tensor maps over the strided views, boxes
// of 32 head-dim columns in TMA's 64-byte swizzle; the bias, whose rows
// TMA cannot address, by plain loads), so no transposed copy is ever
// written to shared memory:
// - dq (launched first): one block per (bh, 64-query tile), the tiles of
//   a head next to each other, so its k and v come from L2.  Q and dO
//   are loaded once; its prologue takes delta of its own rows from O and
//   dO with 16-byte loads and writes it for the dk/dv kernel (no separate
//   delta launch).  For each 64-key tile of K and V: S = Q K^T and dP =
//   dO V^T by wgmma from shared memory (both K-major), P and dS in the
//   accumulator layout (lse and delta are per row: two of each a
//   thread), then dQ += dS K with dS as wgmma's register A operand and K
//   read MN-major through the descriptor's transpose bit.
// - dk/dv: one block per (bh, 64-key tile); K and V loaded once.  For
//   each 64-query tile of Q and dO (with their lse and delta rows, which
//   the producer warp's lanes copy into the stage): S^T = K Q^T and dP^T
//   = V dO^T (K-major), P^T and dS^T formed in registers (lse and delta
//   per column), dV += P^T dO and dK += dS^T Q with Q and dO MN-major.
// - above D = 32 each kernel takes the other side's tile in two halves
//   of 32 rows (m64n32): both scores, their A fragments and the D-wide
//   accumulators stay in registers (dq: 96 registers at D = 64, four
//   blocks an SM; dk/dv: 128, three), and a half wholly past Sq or Sk
//   (the last tile's at S = 197) is skipped.  No variant spills.
// - each kernel issues S and dP together and forms P while dP runs; the
//   dQ (dK, dV) products of a (half) tile run on while the next one's
//   scores are issued: a stage is released to the producer once the wait
//   for the next tile's S shows them done (in-order wgmma groups).  Each
//   consumer warp releases a stage for itself (4 arrivals).
// f32 design: the same two kernels and tiling on split TF32
// (flash_attention.cuh: each product three TF32 products, small terms
// first, f32 sums).  What bounds it: the products at a third of the TF32
// rate: at TrOCR's encoder grid (BH = 192, S = 577, D = 64) 0.248 ms,
// against 0.068 ms for the f32 bytes (about 0.31 S operations a byte: the
// bytes bound it below S of about 160).  What differs from bf16:
// - tf32 wgmma has no transpose bit, so the operands the bf16 kernels read
//   MN-major (K for dQ, Q for dK, dO for dV) get K-major T tiles; and the
//   split doubles every operand tile, so a block is 256 threads: one
//   consumer warpgroup of 64 resident rows and a producer warpgroup whose
//   thread 0 keeps TMA loads (f32 boxes of 32 columns, 128-byte swizzle)
//   in flight and whose 128 threads split each loaded tile in shared
//   memory (big in place, small beside it, the T tile's big and small in
//   the same pass) while the consumers run the previous stage's products;
// - the other side is streamed in stages of 32 rows up to D = 64, 16
//   above (dq: K, K^T, V; dk/dv: Q, Q^T, dO, dO^T, with the rows' lse and
//   delta), through a 2-stage ring of split operands (one stage at D =
//   128); TMA loads the raw tiles into a ring of their own two stages
//   ahead (one for dk/dv at D = 32, which keeps two blocks an SM), so the
//   split of the next stage and the loads of the ones after overlap the
//   consumer's products.  At D = 64 dq takes 193 KB of shared memory and
//   dk/dv 226 KB: one block an SM;
// - S, dP (S^T, dP^T) by m64nNk8 wgmmas from shared memory; P and dS (P^T,
//   dS^T) split in registers into wgmma's A fragments in the T tiles'
//   permuted column order (flash_attention.cuh) for dQ += dS K (dV +=
//   P^T dO, dK += dS^T Q) from registers and the T tiles;
// - S and dP are issued together and P formed while dP runs (dk/dv: dS^T
//   formed while dV runs); a stage's products are waited for before the
//   next stage's and the stage released then.  Left running into the
//   next stage's scores, as the bf16 kernels leave theirs, they make
//   ptxas serialise every wgmma of the kernel (its warning C7515), and
//   the kernels were slower than SDPA's f32 backward on the H100.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

using namespace tlx;

// Element strides of (batch, head, row) of q, k, v, o and dO.
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3];
};

// ---------------------------------------------- f32: split TF32 (Hopper)
// Streamed rows a stage: 32 up to D = 64, 16 above (shared memory).
template <int D>
constexpr int f32_stream_rows() {
  return D <= 64 ? 32 : 16;
}

// dq: Q and dO resident (big, small each); an operand stage holds 32 (16)
// keys: K (big, small) for S = Q K^T, K's T tile (big, small) for dQ =
// dS K, and V (big, small) for dP = dO V^T.  TMA loads K and V into a ring
// of raw stages of their own, two tiles ahead of the split.  At D = 128 one
// operand stage fits.
template <int D>
struct DqF32Layout {
  static constexpr int kRows = f32_stream_rows<D>();
  static constexpr int kStages = D == 128 ? 1 : 2;
  static constexpr int kRaw = 2;
  static constexpr int kRes = kF32Rows * D * 4;  // one part of Q or dO
  static constexpr int kPart = kRows * D * 4;    // one part of a stage
  static constexpr int kRing = 4 * kRes;
  static constexpr int kStage = 6 * kPart;
  static constexpr int kRawAt = kRing + kStages * kStage;
  static constexpr int kRawStage = 2 * kPart;    // K, V as loaded
  static constexpr int kBars = kRawAt + kRaw * kRawStage;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (2 + kRaw + 2 * kStages);
  static_assert(kSmem <= 232448, "shared memory of a block");
};

// dk/dv: K and V resident (big, small each); an operand stage holds 32
// (16) query rows: Q and dO (big, small) for S^T = K Q^T and dP^T = V
// dO^T, their T tiles (big, small) for dK = dS^T Q and dV = P^T dO, and
// the rows' lse and delta; raw stages of Q and dO as dq's.  At D = 128 one
// operand stage fits; at D = 32 one raw stage keeps two blocks an SM.
template <int D>
struct DkdvF32Layout {
  static constexpr int kRows = f32_stream_rows<D>();
  static constexpr int kStages = D == 128 ? 1 : 2;
  static constexpr int kRaw = D == 32 ? 1 : 2;
  static constexpr int kRes = kF32Rows * D * 4;
  static constexpr int kPart = kRows * D * 4;
  static constexpr int kRing = 4 * kRes;
  static constexpr int kStage = 8 * kPart;
  static constexpr int kRawAt = kRing + kStages * kStage;
  static constexpr int kRawStage = 2 * kPart;    // Q, dO as loaded
  static constexpr int kStats = kRawAt + kRaw * kRawStage;
  static constexpr int kBars = kStats + kStages * 2 * kRows * 4;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (2 + kRaw + 2 * kStages);
  static_assert(kSmem <= 232448, "shared memory of a block");
};

// This thread's quarter of a row's dO . O in f32: columns [t D/4,
// (t + 1) D/4), 16-byte loads.
template <int D>
__device__ __forceinline__ float row_dot_f32(const float* o, const float* g,
                                             int t) {
  const float4* po = reinterpret_cast<const float4*>(o + t * (D / 4));
  const float4* pg = reinterpret_cast<const float4*>(g + t * (D / 4));
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const float4 a = po[i], c = pg[i];
    s = fmaf(a.x, c.x, s);
    s = fmaf(a.y, c.y, s);
    s = fmaf(a.z, c.z, s);
    s = fmaf(a.w, c.w, s);
  }
  return s;
}

// Streamed tile j (NS rows of two views) loaded by TMA into raw stage
// j % kRaw at `raw` (the two tiles `part` bytes apart).
template <int D, int NS, int kRaw>
__device__ __forceinline__ void load_stream(uint32_t raw, int part,
                                            const CUtensorMap* ma, bool sa,
                                            const CUtensorMap* mc, bool sc,
                                            const F32Bars& bars, int j, int h,
                                            int b) {
  const int r = j % kRaw;
  const uint32_t dst = raw + r * 2 * part, bar = bars.raw + 8 * r;
  mbar_expect_tx(bar, 2 * part);
#pragma unroll
  for (int c = 0; c < D / kChunk; ++c) {
    load_rows(dst + c * (NS * 128), ma, bar, sa, c * kChunk, j * NS, h, b);
    load_rows(dst + part + c * (NS * 128), mc, bar, sc, c * kChunk, j * NS,
              h, b);
  }
}

// The 64 resident rows from `row` of two views, loaded by TMA into the
// direct tiles at `a` and `c` (each D / 32 boxes of 64 rows).
template <int D>
__device__ __forceinline__ void load_resident(uint32_t a, const CUtensorMap* ma,
                                              bool sa, uint32_t c,
                                              const CUtensorMap* mc, bool sc,
                                              uint32_t bar, int row, int h,
                                              int b) {
  mbar_expect_tx(bar, 2 * kF32Rows * D * 4);
#pragma unroll
  for (int i = 0; i < D / kChunk; ++i) {
    load_rows(a + i * (kF32Rows * 128), ma, bar, sa, i * kChunk, row, h, b);
    load_rows(c + i * (kF32Rows * 128), mc, bar, sc, i * kChunk, row, h, b);
  }
}

// dQ, and delta for the dk/dv kernel.  Accumulators: sacc and dpacc[4 jj
// + e] are query row0 (e < 2) or row1 = row0 + 8, key k0 + 8 jj + 2 t +
// (e & 1).
template <int D, bool kBias>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dq_f32(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_g,
                 const float* __restrict__ o, const float* __restrict__ g,
                 const float* __restrict__ bias,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 float* __restrict__ dq, int Sq, int Sk, int H, Strides st,
                 long long bias_bh_stride, float scale, int swaps) {
  using L = DqF32Layout<D>;
  constexpr int NS = L::kRows, S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* base = smem_raw + (sq - smem_u32(smem_raw));
  const uint32_t sg = sq + 2 * L::kRes;
  const uint32_t ring = sq + L::kRing;
  const uint32_t raw = sq + L::kRawAt;
  const F32Bars bars(sq + L::kBars, L::kRaw, S);

  const int n_qt = (Sq + kF32Rows - 1) / kF32Rows;
  const int bh = blockIdx.x / n_qt;  // a head's query tiles are adjacent
  const int q0 = (blockIdx.x % n_qt) * kF32Rows;
  const int b = bh / H, h = bh % H;
  const int n_kt = (Sk + NS - 1) / NS;

  if (threadIdx.x == 0) bars.init(L::kRaw, S);
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ------------------------------- producer warpgroup: TMA, then split
    const int pt = threadIdx.x - 128;
    if (pt == 0) {
      load_resident<D>(sq, &map_q, swaps & 1, sg, &map_g, swaps & 8,
                       bars.res_load, q0, h, b);
      for (int j = 0; j < L::kRaw && j < n_kt; ++j)
        load_stream<D, NS, L::kRaw>(raw, L::kPart, &map_k, swaps & 2, &map_v,
                                    swaps & 4, bars, j, h, b);
    }
    mbar_wait(bars.res_load, 0);
    split_tile<kF32Rows, D, false>(base, base, L::kRes, nullptr, 0, pt);
    split_tile<kF32Rows, D, false>(base + 2 * L::kRes, base + 2 * L::kRes,
                                   L::kRes, nullptr, 0, pt);
    fence_proxy_async();
    mbar_arrive(bars.res_ready);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % S, r = j % L::kRaw;
      // K, K^T, V of the operand stage: big, small each
      unsigned char* t = base + L::kRing + s * L::kStage;
      unsigned char* src = base + L::kRawAt + r * L::kRawStage;
      mbar_wait(bars.raw + 8 * r, (j / L::kRaw) & 1);
      mbar_wait(bars.empty + 8 * s, ((j / S) & 1) ^ 1);
      split_tile<NS, D, true>(src, t, L::kPart, t + 2 * L::kPart, L::kPart,
                              pt);
      split_tile<NS, D, false>(src + L::kPart, t + 4 * L::kPart, L::kPart,
                               nullptr, 0, pt);
      fence_proxy_async();
      mbar_arrive(bars.full + 8 * s);
      named_barrier(1, 128);  // the raw stage read by every thread
      if (pt == 0 && j + L::kRaw < n_kt)
        load_stream<D, NS, L::kRaw>(raw, L::kPart, &map_k, swaps & 2, &map_v,
                                    swaps & 4, bars, j + L::kRaw, h, b);
    }
    return;
  }
  // ----------------------------------------------------------- consumers
  const int lane = threadIdx.x % 32, t = lane & 3;
  const int row0 = q0 + threadIdx.x / 32 * 16 + (lane >> 2);
  const int row1 = row0 + 8;

  // delta of rows row0 and row1: the row's four threads each take a
  // quarter of the head dim, summed in a fixed order
  float dl0 = 0.f, dl1 = 0.f;
  {
    const float* ob = o + b * st.o[0] + h * st.o[1];
    const float* gb = g + b * st.g[0] + h * st.g[1];
    if (row0 < Sq)
      dl0 = row_dot_f32<D>(ob + row0 * st.o[2], gb + row0 * st.g[2], t);
    if (row1 < Sq)
      dl1 = row_dot_f32<D>(ob + row1 * st.o[2], gb + row1 * st.g[2], t);
  }
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
  const long long stat0 = static_cast<long long>(bh) * Sq;
  if (t == 0) {
    if (row0 < Sq) delta[stat0 + row0] = dl0;
    if (row1 < Sq) delta[stat0 + row1] = dl1;
  }
  const float ls0 = row0 < Sq ? lse[stat0 + row0] : 0.f;
  const float ls1 = row1 < Sq ? lse[stat0 + row1] : 0.f;
  const float* br0 = nullptr;
  const float* br1 = nullptr;
  if (kBias) {
    const float* bb = bias + bh * bias_bh_stride;
    br0 = bb + static_cast<long long>(min(row0, Sq - 1)) * Sk;
    br1 = bb + static_cast<long long>(min(row1, Sq - 1)) * Sk;
  }
  // without bias, P = 2^(s scale log2e - lse log2e)
  const float sc2 = scale * kLog2e;
  const float nl0 = -ls0 * kLog2e, nl1 = -ls1 * kLog2e;
  const float inv_sk = 1.f / Sk;

  float sacc[NS / 2], dpacc[NS / 2], dqacc[D / 2], pv[NS / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;
  uint32_t db[NS / 8][4], ds[NS / 8][4];  // dS's split A fragments

  mbar_wait(bars.res_ready, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % S;
    const uint32_t sk = ring + s * L::kStage;
    const uint32_t sv = sk + 4 * L::kPart;
    const int k0 = j * NS;
    mbar_wait(bars.full + 8 * s, (j / S) & 1);

    // S = Q K^T and dP = dO V^T: per k8 step along the head dim, three
    // TF32 products each
    fence_regs(sacc);
    fence_regs(dpacc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
      mma3_ss<NS>(sacc, desc_dir<kF32Rows>(sq, ks),
                  desc_dir<kF32Rows>(sq + L::kRes, ks), desc_dir<NS>(sk, ks),
                  desc_dir<NS>(sk + L::kPart, ks), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
      mma3_ss<NS>(dpacc, desc_dir<kF32Rows>(sg, ks),
                  desc_dir<kF32Rows>(sg + L::kRes, ks), desc_dir<NS>(sv, ks),
                  desc_dir<NS>(sv + L::kPart, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S
    fence_regs(sacc);

    // P while dP runs
    const bool ragged = k0 + NS > Sk;
    uint32_t clamped = 0;  // bias: the scores the clamp took (dS = 0)
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {
      const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      float p;
      if (kBias) {
        const float ls = (i & 2) ? ls1 : ls0;
        const float xr = fmaf(sacc[i], scale,
                              col < Sk ? ((i & 2) ? br1 : br0)[col] : 0.f);
        p = ls == kNeg ? inv_sk : exp2_ftz((fmaxf(xr, kNeg) - ls) * kLog2e);
        if (xr < kNeg) clamped |= 1u << i;
      } else {
        p = exp2_ftz(fmaf(sacc[i], sc2, (i & 2) ? nl1 : nl0));
      }
      if (ragged && col >= Sk) p = 0.f;
      pv[i] = p;
    }

    // dS = P (dP - delta), split into the A fragments of dQ += dS K
    wgmma_wait<0>();  // dP
    fence_regs(dpacc);
#pragma unroll
    for (int kk = 0; kk < NS / 8; ++kk) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * kk + e;
        d[e] = pv[i] * (dpacc[i] - ((e & 2) ? dl1 : dl0));
        if (kBias && (clamped >> i & 1)) d[e] = 0.f;
      }
      split_frag(d, db[kk], ds[kk]);
    }
    fence_regs(db);
    fence_regs(ds);
    fence_regs(dqacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 8; ++kk)
      mma3_rs<D>(dqacc, db[kk], ds[kk],
                 desc_tr<NS>(sk + 2 * L::kPart, kk),
                 desc_tr<NS>(sk + 3 * L::kPart, kk));
    wgmma_commit();
    // the stage's products done before the next stage's: products left
    // running into the next stage's scores make ptxas serialise every
    // wgmma of the kernel (C7515; see the file's head)
    wgmma_wait<0>();
    fence_regs(dqacc);
    if (lane == 0) mbar_arrive(bars.empty + 8 * s);
  }

  float* out = dq + static_cast<long long>(bh) * Sq * D;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<float2*>(out + row0 * D + col) =
          make_float2(dqacc[4 * jj] * scale, dqacc[4 * jj + 1] * scale);
    if (row1 < Sq)
      *reinterpret_cast<float2*>(out + row1 * D + col) =
          make_float2(dqacc[4 * jj + 2] * scale, dqacc[4 * jj + 3] * scale);
  }
}

// dK and dV.  Accumulators: sacc and dpacc[4 jj + e] are key key0 (e < 2)
// or key1 = key0 + 8, query q0 + 8 jj + 2 t + (e & 1) of the stage.
template <int D, bool kBias>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dkdv_f32(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_g,
                   const float* __restrict__ bias,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int Sq, int Sk, int H,
                   long long bias_bh_stride, float scale, int swaps) {
  using L = DkdvF32Layout<D>;
  constexpr int NS = L::kRows, S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sk = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* base = smem_raw + (sk - smem_u32(smem_raw));
  const uint32_t sv = sk + 2 * L::kRes;
  const uint32_t ring = sk + L::kRing;
  float* stats = reinterpret_cast<float*>(base + L::kStats);  // + 2 NS s
  const uint32_t raw = sk + L::kRawAt;
  const F32Bars bars(sk + L::kBars, L::kRaw, S);

  const int n_kt = (Sk + kF32Rows - 1) / kF32Rows;
  const int bh = blockIdx.x / n_kt;  // a head's key tiles are adjacent
  const int k0 = (blockIdx.x % n_kt) * kF32Rows;
  const int b = bh / H, h = bh % H;
  const int n_qt = (Sq + NS - 1) / NS;

  if (threadIdx.x == 0) bars.init(L::kRaw, S);
  __syncthreads();

  if (threadIdx.x >= 128) {
    // --------------------- producer warpgroup: TMA, the stats, then split
    const int pt = threadIdx.x - 128;
    if (pt == 0) {
      load_resident<D>(sk, &map_k, swaps & 2, sv, &map_v, swaps & 4,
                       bars.res_load, k0, h, b);
      for (int j = 0; j < L::kRaw && j < n_qt; ++j)
        load_stream<D, NS, L::kRaw>(raw, L::kPart, &map_q, swaps & 1, &map_g,
                                    swaps & 8, bars, j, h, b);
    }
    mbar_wait(bars.res_load, 0);
    split_tile<kF32Rows, D, false>(base, base, L::kRes, nullptr, 0, pt);
    split_tile<kF32Rows, D, false>(base + 2 * L::kRes, base + 2 * L::kRes,
                                   L::kRes, nullptr, 0, pt);
    fence_proxy_async();
    mbar_arrive(bars.res_ready);
    const float* lr = lse + static_cast<long long>(bh) * Sq;
    const float* dr = delta + static_cast<long long>(bh) * Sq;
    for (int j = 0; j < n_qt; ++j) {
      const int s = j % S, r = j % L::kRaw, q0 = j * NS;
      // Q, Q^T, dO, dO^T of the operand stage: big, small each
      unsigned char* t = base + L::kRing + s * L::kStage;
      unsigned char* src = base + L::kRawAt + r * L::kRawStage;
      mbar_wait(bars.empty + 8 * s, ((j / S) & 1) ^ 1);
      float* sts = stats + s * 2 * NS;  // lse, then delta
      if (pt < 2 * NS) {
        const int row = q0 + pt % NS;
        sts[pt] = row < Sq ? (pt < NS ? lr : dr)[row] : 0.f;
      }
      mbar_wait(bars.raw + 8 * r, (j / L::kRaw) & 1);
      split_tile<NS, D, true>(src, t, L::kPart, t + 2 * L::kPart, L::kPart,
                              pt);
      split_tile<NS, D, true>(src + L::kPart, t + 4 * L::kPart, L::kPart,
                              t + 6 * L::kPart, L::kPart, pt);
      fence_proxy_async();
      mbar_arrive(bars.full + 8 * s);
      named_barrier(1, 128);  // the raw stage read by every thread
      if (pt == 0 && j + L::kRaw < n_qt)
        load_stream<D, NS, L::kRaw>(raw, L::kPart, &map_q, swaps & 1, &map_g,
                                    swaps & 8, bars, j + L::kRaw, h, b);
    }
    return;
  }
  // ----------------------------------------------------------- consumers
  const int lane = threadIdx.x % 32, t = lane & 3;
  const int key0 = k0 + threadIdx.x / 32 * 16 + (lane >> 2);
  const int key1 = key0 + 8;
  const float* bk0 = nullptr;
  const float* bk1 = nullptr;
  if (kBias) {
    const float* bb = bias + bh * bias_bh_stride;
    bk0 = bb + min(key0, Sk - 1);
    bk1 = bb + min(key1, Sk - 1);
  }
  const float sc2 = scale * kLog2e;
  const float inv_sk = 1.f / Sk;
  const bool keys_ragged = k0 + kF32Rows > Sk;

  float sacc[NS / 2], dpacc[NS / 2], dkacc[D / 2], dvacc[D / 2], pv[NS / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.f;
  // P^T and dS^T as split A fragments
  uint32_t pb[NS / 8][4], ps[NS / 8][4], db[NS / 8][4], ds[NS / 8][4];

  mbar_wait(bars.res_ready, 0);
  for (int j = 0; j < n_qt; ++j) {
    const int s = j % S, q0 = j * NS;
    const uint32_t sq = ring + s * L::kStage;
    const uint32_t sg = sq + 4 * L::kPart;
    const float* sts = stats + s * 2 * NS;  // lse, then delta
    const bool ragged = keys_ragged || q0 + NS > Sq;
    mbar_wait(bars.full + 8 * s, (j / S) & 1);

    // S^T = K Q^T and dP^T = V dO^T over this stage's queries
    fence_regs(sacc);
    fence_regs(dpacc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
      mma3_ss<NS>(sacc, desc_dir<kF32Rows>(sk, ks),
                  desc_dir<kF32Rows>(sk + L::kRes, ks), desc_dir<NS>(sq, ks),
                  desc_dir<NS>(sq + L::kPart, ks), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
      mma3_ss<NS>(dpacc, desc_dir<kF32Rows>(sv, ks),
                  desc_dir<kF32Rows>(sv + L::kRes, ks), desc_dir<NS>(sg, ks),
                  desc_dir<NS>(sg + L::kPart, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S^T
    fence_regs(sacc);

    // P^T while dP^T runs; lse per column
    uint32_t clamped = 0;  // bias: the scores the clamp took (dS = 0)
#pragma unroll
    for (int jj = 0; jj < NS / 8; ++jj) {
      const int c = 8 * jj + 2 * t;
      const float2 ls = *reinterpret_cast<const float2*>(sts + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e;
        const float l = (e & 1) ? ls.y : ls.x;
        const int gq = q0 + c + (e & 1);
        float p;
        if (kBias) {
          const float* bk = (e & 2) ? bk1 : bk0;
          const float xr = fmaf(
              sacc[i], scale,
              gq < Sq ? bk[static_cast<long long>(gq) * Sk] : 0.f);
          p = l == kNeg ? inv_sk : exp2_ftz((fmaxf(xr, kNeg) - l) * kLog2e);
          if (xr < kNeg) clamped |= 1u << i;
        } else {
          p = exp2_ftz(fmaf(sacc[i], sc2, -l * kLog2e));
        }
        if (ragged && (gq >= Sq || ((e & 2) ? key1 : key0) >= Sk)) p = 0.f;
        pv[i] = p;
      }
      split_frag(pv + 4 * jj, pb[jj], ps[jj]);
    }
    // dV += P^T dO, B from dO's T tile
    fence_regs(pb);
    fence_regs(ps);
    fence_regs(dvacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 8; ++kk)
      mma3_rs<D>(dvacc, pb[kk], ps[kk], desc_tr<NS>(sq + 6 * L::kPart, kk),
                 desc_tr<NS>(sq + 7 * L::kPart, kk));
    wgmma_commit();

    // dS^T = P^T (dP^T - delta); dK += dS^T Q, B from Q's T tile
    wgmma_wait<1>();  // dP^T
    fence_regs(dpacc);
#pragma unroll
    for (int jj = 0; jj < NS / 8; ++jj) {
      const float2 dl =
          *reinterpret_cast<const float2*>(sts + NS + 8 * jj + 2 * t);
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e;
        d[e] = pv[i] * (dpacc[i] - ((e & 1) ? dl.y : dl.x));
        if (kBias && (clamped >> i & 1)) d[e] = 0.f;
      }
      split_frag(d, db[jj], ds[jj]);
    }
    fence_regs(db);
    fence_regs(ds);
    fence_regs(dkacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 8; ++kk)
      mma3_rs<D>(dkacc, db[kk], ds[kk], desc_tr<NS>(sq + 2 * L::kPart, kk),
                 desc_tr<NS>(sq + 3 * L::kPart, kk));
    wgmma_commit();
    wgmma_wait<0>();  // as dq's: the stage's products done, then release it
    fence_regs(dvacc);
    fence_regs(dkacc);
    if (lane == 0) mbar_arrive(bars.empty + 8 * s);
  }

  const long long base_o = static_cast<long long>(bh) * Sk * D;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + 2 * t;
    if (key0 < Sk) {
      const long long off = base_o + static_cast<long long>(key0) * D + col;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(dkacc[4 * jj] * scale, dkacc[4 * jj + 1] * scale);
      *reinterpret_cast<float2*>(dv + off) =
          make_float2(dvacc[4 * jj], dvacc[4 * jj + 1]);
    }
    if (key1 < Sk) {
      const long long off = base_o + static_cast<long long>(key1) * D + col;
      *reinterpret_cast<float2*>(dk + off) = make_float2(
          dkacc[4 * jj + 2] * scale, dkacc[4 * jj + 3] * scale);
      *reinterpret_cast<float2*>(dv + off) =
          make_float2(dvacc[4 * jj + 2], dvacc[4 * jj + 3]);
    }
  }
}


// --------------------------------------------- bf16: TMA + wgmma (Hopper)
constexpr int kRows = 64;          // keys (dk/dv) or queries (dq) a block
constexpr int kStages = 2;
constexpr int kBf16Threads = 160;  // one consumer warpgroup + a producer warp

template <int D>
struct Bf16Layout {
  static constexpr int kBox = kRows * kChunk * 2;        // 4 KB
  static constexpr int kTile = (D / kChunk) * kBox;      // 64 rows x D
  // two resident tiles (dq: Q, dO; dk/dv: K, V), kStages stages of two
  // streamed tiles (dq: K, V; dk/dv: Q, dO), the streamed rows' lse and
  // delta (dk/dv), then the barriers: resident, full x kStages, empty x
  // kStages
  static constexpr int kRing = 2 * kTile;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kStats = kRing + kStages * kStage;
  static constexpr int kBars = kStats + kStages * 2 * kRows * 4;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (1 + 2 * kStages);
};

// The 64 rows from `row` of the (b, h) view into a tile: D / 32 boxes.
template <int D>
__device__ __forceinline__ void load_tile_bf16(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, bool swap,
                                               int row, int h, int b) {
#pragma unroll
  for (int c = 0; c < D / kChunk; ++c)
    load_rows(dst + c * Bf16Layout<D>::kBox, map, bar, swap, c * kChunk, row,
              h, b);
}

// A K-major wgmma operand: k16 step `ks` (along the head dim) of a tile's
// rows from `row` (a multiple of 8): two k16 steps a 64-byte box row,
// groups of 8 rows 512 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks, int row) {
  return smem_desc(tile + (ks >> 1) * (kRows * kChunk * 2) + (ks & 1) * 32 +
                       row * (kChunk * 2),
                   16, 512, kSwizzle64B);
}

// An MN-major wgmma B operand: the tile's rows [row, row + 16) as one k16
// step over all D columns, its 32-column boxes 4 KB apart (LBO).
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int row) {
  return smem_desc(tile + row * (kChunk * 2), kRows * kChunk * 2, 512,
                   kSwizzle64B);
}

// The A-fragment register of accumulator pair (i, i + 1) (i even) of the
// m64nN accumulator: key group i / 4 of 8 columns, row half (i & 2).
#define TLX_A_FRAG(a, i) (a)[(i) / 8][(((i) / 4) & 1) * 2 + (((i) & 2) ? 1 : 0)]

// This thread's quarter of a row's dO . O: columns [t D/4, (t + 1) D/4),
// 16-byte loads.
template <int D>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* o,
                                         const __nv_bfloat16* g, int t) {
  const uint4* po = reinterpret_cast<const uint4*>(o + t * (D / 4));
  const uint4* pg = reinterpret_cast<const uint4*>(g + t * (D / 4));
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const uint4 a = po[i], c = pg[i];
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 fa = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&aw[w]));
      const float2 fc = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&cw[w]));
      s = fmaf(fa.x, fc.x, s);
      s = fmaf(fa.y, fc.y, s);
    }
  }
  return s;
}

// dQ, and delta for the dk/dv kernel.  Accumulators: sacc and dpacc[4 jj
// + e] are query row0 (e < 2) or row1 = row0 + 8, key k0 + 8 jj + 2 t +
// (e & 1).
template <int D, bool kBias>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_g,
                  const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ g,
                  const float* __restrict__ bias,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
                  Strides st, long long bias_bh_stride, float scale,
                  int swaps) {
  using L = Bf16Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sg = sq + L::kTile;
  const uint32_t ring = sq + L::kRing;
  const uint32_t bar_q = sq + L::kBars;
  const uint32_t bar_full = bar_q + 8;                // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 s

  const int n_qt = (Sq + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_qt;  // a head's query tiles are adjacent
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int b = bh / H, h = bh % H;
  const int n_kt = (Sk + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x != 128) return;
    mbar_expect_tx(bar_q, 2 * L::kTile);
    load_tile_bf16<D>(sq, &map_q, bar_q, swaps & 1, q0, h, b);
    load_tile_bf16<D>(sg, &map_g, bar_q, swaps & 8, q0, h, b);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % kStages;
      mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
      const uint32_t sk = ring + s * L::kStage;
      mbar_expect_tx(bar_full + 8 * s, 2 * L::kTile);
      load_tile_bf16<D>(sk, &map_k, bar_full + 8 * s, swaps & 2, j * kRows,
                        h, b);
      load_tile_bf16<D>(sk + L::kTile, &map_v, bar_full + 8 * s, swaps & 4,
                        j * kRows, h, b);
    }
    return;
  }
  // ----------------------------------------------------------- consumers
  const int lane = threadIdx.x % 32, t = lane & 3;
  const int row0 = q0 + threadIdx.x / 32 * 16 + (lane >> 2);
  const int row1 = row0 + 8;

  // delta of rows row0 and row1: the row's four threads each take a
  // quarter of the head dim, summed in a fixed order
  float dl0 = 0.f, dl1 = 0.f;
  {
    const __nv_bfloat16* ob = o + b * st.o[0] + h * st.o[1];
    const __nv_bfloat16* gb = g + b * st.g[0] + h * st.g[1];
    if (row0 < Sq)
      dl0 = row_dot<D>(ob + row0 * st.o[2], gb + row0 * st.g[2], t);
    if (row1 < Sq)
      dl1 = row_dot<D>(ob + row1 * st.o[2], gb + row1 * st.g[2], t);
  }
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
  const long long stat0 = static_cast<long long>(bh) * Sq;
  if (t == 0) {
    if (row0 < Sq) delta[stat0 + row0] = dl0;
    if (row1 < Sq) delta[stat0 + row1] = dl1;
  }
  const float ls0 = row0 < Sq ? lse[stat0 + row0] : 0.f;
  const float ls1 = row1 < Sq ? lse[stat0 + row1] : 0.f;
  const float* br0 = nullptr;
  const float* br1 = nullptr;
  if (kBias) {
    const float* bb = bias + bh * bias_bh_stride;
    br0 = bb + static_cast<long long>(min(row0, Sq - 1)) * Sk;
    br1 = bb + static_cast<long long>(min(row1, Sq - 1)) * Sk;
  }
  // without bias, P = 2^(s scale log2e - lse log2e)
  const float sc2 = scale * kLog2e;
  const float nl0 = -ls0 * kLog2e, nl1 = -ls1 * kLog2e;
  const float inv_sk = 1.f / Sk;

  // keys of one sub-tile of S and dP: the whole 64-key tile at D = 32,
  // halves of 32 above (dQ takes D / 2 registers a thread)
  constexpr int NK = D <= 32 ? 64 : 32;
  float sacc[NK / 2], dpacc[NK / 2], dqacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;
  uint32_t da[NK / 16][4];  // dS as the A fragments of NK / 16 k16 steps

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages;
    const uint32_t sk = ring + s * L::kStage;
    const uint32_t sv = sk + L::kTile;
    const int k0 = j * kRows;
    mbar_wait(bar_full + 8 * s, (j / kStages) & 1);
#pragma unroll
    for (int hk = 0; hk < kRows / NK; ++hk) {
      const int c0 = hk * NK;  // the sub-tile's first key in the tile
      if (k0 + c0 >= Sk) break;  // wholly past Sk (the last tile's rest)

      // S = Q K^T and dP = dO V^T, k16 steps along the head dim
      fence_regs(sacc);
      fence_regs(dpacc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss<NK, 0>(sacc, desc_k(sq, ks, 0), desc_k(sk, ks, c0), ks > 0);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss<NK, 0>(dpacc, desc_k(sg, ks, 0), desc_k(sv, ks, c0),
                        ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // S, and the previous sub-tile's dQ product
      fence_regs(sacc);
      if (hk == 0 && j > 0 && lane == 0)
        mbar_arrive(bar_empty + 8 * ((j - 1) % kStages));

      // P in place of S while dP runs
      const bool ragged = k0 + c0 + NK > Sk;
      uint32_t clamped = 0;  // bias: the scores the clamp took (dS = 0)
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) {
        const int col = k0 + c0 + 8 * (i / 4) + 2 * t + (i & 1);
        float p;
        if (kBias) {
          const float ls = (i & 2) ? ls1 : ls0;
          const float xr = fmaf(
              sacc[i], scale, col < Sk ? ((i & 2) ? br1 : br0)[col] : 0.f);
          p = ls == kNeg ? inv_sk : exp2_ftz((fmaxf(xr, kNeg) - ls) * kLog2e);
          if (xr < kNeg) clamped |= 1u << i;
        } else {
          p = exp2_ftz(fmaf(sacc[i], sc2, (i & 2) ? nl1 : nl0));
        }
        if (ragged && col >= Sk) p = 0.f;
        sacc[i] = p;
      }

      // dS = P (dP - delta), rounded to bf16 as the A operand of dQ += dS K
      wgmma_wait<0>();  // dP
      fence_regs(dpacc);
#pragma unroll
      for (int i = 0; i < NK / 2; i += 2) {
        const float dl = (i & 2) ? dl1 : dl0;
        float d0 = sacc[i] * (dpacc[i] - dl);
        float d1 = sacc[i + 1] * (dpacc[i + 1] - dl);
        if (kBias) {
          if (clamped >> i & 1) d0 = 0.f;
          if (clamped >> (i + 1) & 1) d1 = 0.f;
        }
        TLX_A_FRAG(da, i) = pack_bf16(d0, d1);
      }
      fence_regs(da);
      fence_regs(dqacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
        wgmma_rs<D>(dqacc, da[kk], desc_mn(sk, c0 + 16 * kk), 1);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  fence_regs(dqacc);

  __nv_bfloat16* out = dq + static_cast<long long>(bh) * Sq * D;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + row0 * D + col) =
          __floats2bfloat162_rn(dqacc[4 * jj] * scale,
                                dqacc[4 * jj + 1] * scale);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + row1 * D + col) =
          __floats2bfloat162_rn(dqacc[4 * jj + 2] * scale,
                                dqacc[4 * jj + 3] * scale);
  }
}

// dK and dV.  Accumulators: sacc and dpacc[4 jj + e] are key key0 (e < 2)
// or key1 = key0 + 8, query c0 + 8 jj + 2 t + (e & 1) of the tile (c0 the
// sub-tile's first).  Without bias, up to D = 64, three blocks an SM (at
// most 136 registers a thread; 128 used, no spill): occupancy is what
// hides the short loops' latency at ViT's grid, where it measured faster
// on the H100 than two blocks an SM, and three ring stages or a register
// cap on the dq kernel did not.
template <int D, bool kBias>
__global__ void __launch_bounds__(kBf16Threads, D <= 64 && !kBias ? 3 : 1)
flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_g,
                    const float* __restrict__ bias,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
                    long long bias_bh_stride, float scale, int swaps) {
  using L = Bf16Layout<D>;
  // queries of one sub-tile of S^T and dP^T: the whole 64-query tile at
  // D = 32, halves of 32 above (dK and dV take D / 2 registers each a
  // thread)
  constexpr int NQ = D <= 32 ? 64 : 32;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sk = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sv = sk + L::kTile;
  const uint32_t ring = sk + L::kRing;
  float* stats = reinterpret_cast<float*>(
      smem_raw + (sk - smem_u32(smem_raw)) + L::kStats);  // + 2 kRows s
  const uint32_t bar_kv = sk + L::kBars;
  const uint32_t bar_full = bar_kv + 8;               // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 s

  const int n_kt = (Sk + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_kt;  // a head's key tiles are adjacent
  const int k0 = (blockIdx.x % n_kt) * kRows;
  const int b = bh / H, h = bh % H;
  const int n_qt = (Sq + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 33);  // the TMA's + the 32 lanes' stats
      mbar_init(bar_empty + 8 * s, 4);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // -------------------------------------- producer: TMA and the stats
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * L::kTile);
      load_tile_bf16<D>(sk, &map_k, bar_kv, swaps & 2, k0, h, b);
      load_tile_bf16<D>(sv, &map_v, bar_kv, swaps & 4, k0, h, b);
    }
    const float* lr = lse + static_cast<long long>(bh) * Sq;
    const float* dr = delta + static_cast<long long>(bh) * Sq;
    for (int j = 0; j < n_qt; ++j) {
      const int s = j % kStages, q0 = j * kRows;
      mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t sq = ring + s * L::kStage;
        mbar_expect_tx(bar_full + 8 * s, 2 * L::kTile);
        load_tile_bf16<D>(sq, &map_q, bar_full + 8 * s, swaps & 1, q0, h, b);
        load_tile_bf16<D>(sq + L::kTile, &map_g, bar_full + 8 * s, swaps & 8,
                          q0, h, b);
      }
      float* st = stats + s * 2 * kRows;
      for (int r = lane; r < kRows; r += 32) {
        const bool in = q0 + r < Sq;
        st[r] = in ? lr[q0 + r] : 0.f;
        st[kRows + r] = in ? dr[q0 + r] : 0.f;
      }
      mbar_arrive(bar_full + 8 * s);
    }
    return;
  }
  // ----------------------------------------------------------- consumers
  const int lane = threadIdx.x % 32, t = lane & 3;
  const int key0 = k0 + threadIdx.x / 32 * 16 + (lane >> 2);
  const int key1 = key0 + 8;
  const float* bk0 = nullptr;
  const float* bk1 = nullptr;
  if (kBias) {
    const float* bb = bias + bh * bias_bh_stride;
    bk0 = bb + min(key0, Sk - 1);
    bk1 = bb + min(key1, Sk - 1);
  }
  const float sc2 = scale * kLog2e;
  const float inv_sk = 1.f / Sk;
  const bool keys_ragged = k0 + kRows > Sk;

  float sacc[NQ / 2], dpacc[NQ / 2], dkacc[D / 2], dvacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.f;
  uint32_t pa[NQ / 16][4], da[NQ / 16][4];  // P^T, dS^T as A fragments

  mbar_wait(bar_kv, 0);
  for (int j = 0; j < n_qt; ++j) {
    const int s = j % kStages, q0 = j * kRows;
    const uint32_t sq = ring + s * L::kStage;
    const uint32_t sg = sq + L::kTile;
    const float* st = stats + s * 2 * kRows;  // lse, then delta
    const bool ragged = keys_ragged || q0 + kRows > Sq;
    mbar_wait(bar_full + 8 * s, (j / kStages) & 1);
#pragma unroll
    for (int hq = 0; hq < kRows / NQ; ++hq) {
      const int c0 = hq * NQ;  // the sub-tile's first query in the tile
      if (q0 + c0 >= Sq) break;  // wholly past Sq (the last tile's rest)

      // S^T = K Q^T and dP^T = V dO^T over this sub-tile's queries
      fence_regs(sacc);
      fence_regs(dpacc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss<NQ, 0>(sacc, desc_k(sk, ks, 0), desc_k(sq, ks, c0), ks > 0);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss<NQ, 0>(dpacc, desc_k(sv, ks, 0), desc_k(sg, ks, c0),
                        ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // S^T, and the previous sub-tile's dV and dK
      fence_regs(sacc);
      if (hq == 0 && j > 0 && lane == 0)
        mbar_arrive(bar_empty + 8 * ((j - 1) % kStages));

      // P^T in place of S^T while dP^T runs; lse per column
      uint32_t clamped = 0;  // bias: the scores the clamp took (dS = 0)
#pragma unroll
      for (int jj = 0; jj < NQ / 8; ++jj) {
        const int c = c0 + 8 * jj + 2 * t;
        const float2 ls = *reinterpret_cast<const float2*>(st + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          const float l = (e & 1) ? ls.y : ls.x;
          const int gq = q0 + c + (e & 1);
          float p;
          if (kBias) {
            const float* bk = (e & 2) ? bk1 : bk0;
            const float xr = fmaf(
                sacc[i], scale,
                gq < Sq ? bk[static_cast<long long>(gq) * Sk] : 0.f);
            p = l == kNeg ? inv_sk : exp2_ftz((fmaxf(xr, kNeg) - l) * kLog2e);
            if (xr < kNeg) clamped |= 1u << i;
          } else {
            p = exp2_ftz(fmaf(sacc[i], sc2, -l * kLog2e));
          }
          if (ragged && (gq >= Sq || ((e & 2) ? key1 : key0) >= Sk)) p = 0.f;
          sacc[i] = p;
        }
        TLX_A_FRAG(pa, 4 * jj) = pack_bf16(sacc[4 * jj], sacc[4 * jj + 1]);
        TLX_A_FRAG(pa, 4 * jj + 2) =
            pack_bf16(sacc[4 * jj + 2], sacc[4 * jj + 3]);
      }
      // dV += P^T dO
      fence_regs(pa);
      fence_regs(dvacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk)
        wgmma_rs<D>(dvacc, pa[kk], desc_mn(sg, c0 + 16 * kk), 1);
      wgmma_commit();

      // dS^T = P^T (dP^T - delta); dK += dS^T Q
      wgmma_wait<1>();  // dP^T
      fence_regs(dpacc);
#pragma unroll
      for (int jj = 0; jj < NQ / 8; ++jj) {
        const int c = c0 + 8 * jj + 2 * t;
        const float2 dl = *reinterpret_cast<const float2*>(st + kRows + c);
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int i = 4 * jj + e;
          float d0 = sacc[i] * (dpacc[i] - dl.x);
          float d1 = sacc[i + 1] * (dpacc[i + 1] - dl.y);
          if (kBias) {
            if (clamped >> i & 1) d0 = 0.f;
            if (clamped >> (i + 1) & 1) d1 = 0.f;
          }
          TLX_A_FRAG(da, i) = pack_bf16(d0, d1);
        }
      }
      fence_regs(da);
      fence_regs(dkacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk)
        wgmma_rs<D>(dkacc, da[kk], desc_mn(sq, c0 + 16 * kk), 1);
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  fence_regs(dkacc);
  fence_regs(dvacc);

  const long long base = static_cast<long long>(bh) * Sk * D;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + 2 * t;
    if (key0 < Sk) {
      const long long off = base + static_cast<long long>(key0) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(
          dkacc[4 * jj] * scale, dkacc[4 * jj + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dvacc[4 * jj], dvacc[4 * jj + 1]);
    }
    if (key1 < Sk) {
      const long long off = base + static_cast<long long>(key1) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(
          dkacc[4 * jj + 2] * scale, dkacc[4 * jj + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dvacc[4 * jj + 2], dvacc[4 * jj + 3]);
    }
  }
}
#undef TLX_A_FRAG

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

// f32: dq (which writes delta), then dk/dv.  maps: the dq kernel's q,
// k, v, dO (64-row q and dO boxes, streamed-row k and v boxes), then the
// dk/dv kernel's (the other way round).
template <int D, bool kBias>
cudaError_t launch_f32_kind(const CUtensorMap* maps, const void* o,
                            const void* g, const float* bias,
                            const float* lse, float* delta, void* dq,
                            void* dk, void* dv, int bh, int sq, int sk,
                            int heads, const Strides& st,
                            long long bias_bh_stride, float scale,
                            const int* swaps, cudaStream_t stream) {
  constexpr size_t q_smem = DqF32Layout<D>::kSmem;
  constexpr size_t kv_smem = DkdvF32Layout<D>::kSmem;
  static const cudaError_t err =  // once per process and variant
      set_smem(flash_bwd_dkdv_f32<D, kBias>, kv_smem,
               flash_bwd_dq_f32<D, kBias>, q_smem);
  if (err != cudaSuccess) return err;
  const long long q_blocks = (long long)bh * ((sq + kF32Rows - 1) / kF32Rows);
  const long long kv_blocks = (long long)bh * ((sk + kF32Rows - 1) / kF32Rows);
  if (kv_blocks >= (1ll << 31) || q_blocks >= (1ll << 31))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  flash_bwd_dq_f32<D, kBias><<<(unsigned)q_blocks, kF32Threads, q_smem,
                               stream>>>(
      maps[0], maps[1], maps[2], maps[3], f(o), f(g), bias, lse, delta,
      w(dq), sq, sk, heads, st, bias_bh_stride, scale, swaps[0]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_f32<D, kBias><<<(unsigned)kv_blocks, kF32Threads, kv_smem,
                                 stream>>>(
      maps[4], maps[5], maps[6], maps[7], bias, lse, delta, w(dk), w(dv), sq,
      sk, heads, bias_bh_stride, scale, swaps[1]);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* g, const float* bias,
                       const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int batch, int heads, int sq, int sk,
                       const Strides& st, long long bias_bh_stride,
                       float scale, cudaStream_t stream) {
  CUtensorMap maps[8];  // q, k, v, dO for the dq kernel, then for dk/dv
  const void* bases[4] = {q, k, v, g};
  const long long* strides[4] = {st.q, st.k, st.v, st.g};
  const int lengths[4] = {sq, sk, sk, sq};
  const bool resident_dq[4] = {true, false, false, true};
  int swaps[2] = {0, 0};
  for (int kernel = 0; kernel < 2; ++kernel)
    for (int i = 0; i < 4; ++i) {
      const bool resident = resident_dq[i] != (kernel == 1);
      bool swap;
      if (!make_view_map(&maps[4 * kernel + i], bases[i], strides[i], batch,
                         heads, lengths[i], D,
                         resident ? kF32Rows : f32_stream_rows<D>(), &swap,
                         true))
        return cudaErrorInvalidValue;
      swaps[kernel] |= swap << i;
    }
  const int bh = batch * heads;
  if (bias != nullptr)
    return launch_f32_kind<D, true>(maps, o, g, bias, lse, delta, dq, dk, dv,
                                    bh, sq, sk, heads, st, bias_bh_stride,
                                    scale, swaps, stream);
  return launch_f32_kind<D, false>(maps, o, g, bias, lse, delta, dq, dk, dv,
                                   bh, sq, sk, heads, st, bias_bh_stride,
                                   scale, swaps, stream);
}

// bf16: dq (which writes delta), then dk/dv, on one set of tensor maps.
template <int D, bool kBias>
cudaError_t launch_bf16_kind(const CUtensorMap* maps, const void* o,
                             const void* g, const float* bias,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int bh, int sq, int sk,
                             int heads, const Strides& st,
                             long long bias_bh_stride, float scale, int swaps,
                             cudaStream_t stream) {
  constexpr size_t smem = Bf16Layout<D>::kSmem;
  static const cudaError_t err =  // once per process and variant
      set_smem(flash_bwd_dkdv_bf16<D, kBias>, smem,
               flash_bwd_dq_bf16<D, kBias>, smem);
  if (err != cudaSuccess) return err;
  const long long q_blocks = (long long)bh * ((sq + kRows - 1) / kRows);
  const long long kv_blocks = (long long)bh * ((sk + kRows - 1) / kRows);
  if (kv_blocks >= (1ll << 31) || q_blocks >= (1ll << 31))
    return cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  flash_bwd_dq_bf16<D, kBias><<<(unsigned)q_blocks, kBf16Threads, smem,
                                stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(o),
      static_cast<const T*>(g), bias, lse, delta, static_cast<T*>(dq), sq, sk,
      heads, st, bias_bh_stride, scale, swaps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_bf16<D, kBias><<<(unsigned)kv_blocks, kBf16Threads, smem,
                                  stream>>>(
      maps[0], maps[1], maps[2], maps[3], bias, lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, heads,
      bias_bh_stride, scale, swaps);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* g, const float* bias,
                        const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int batch, int heads, int sq, int sk,
                        const Strides& st, long long bias_bh_stride,
                        float scale, cudaStream_t stream) {
  CUtensorMap maps[4];  // q, k, v, dO: 64-row tiles
  const void* bases[4] = {q, k, v, g};
  const long long* strides[4] = {st.q, st.k, st.v, st.g};
  const int lengths[4] = {sq, sk, sk, sq};
  int swaps = 0;
  for (int i = 0; i < 4; ++i) {
    bool swap;
    if (!make_view_map(&maps[i], bases[i], strides[i], batch, heads,
                       lengths[i], D, kRows, &swap))
      return cudaErrorInvalidValue;
    swaps |= swap << i;
  }
  const int bh = batch * heads;
  if (bias != nullptr)
    return launch_bf16_kind<D, true>(maps, o, g, bias, lse, delta, dq, dk, dv,
                                     bh, sq, sk, heads, st, bias_bh_stride,
                                     scale, swaps, stream);
  return launch_bf16_kind<D, false>(maps, o, g, bias, lse, delta, dq, dk, dv,
                                    bh, sq, sk, heads, st, bias_bh_stride,
                                    scale, swaps, stream);
}

}  // namespace

// q, o, dout: [batch, heads, sq, d] and k, v: [batch, heads, sk, d], given
// by element strides (15 values: batch, head and row strides of q, k, v,
// o and dout in turn), the head dim contiguous; all f32 or all bf16
// (is_bf16), every row 16-byte aligned and every stride a whole number of
// 16-byte units.  bias: null or contiguous f32 [1 or
// batch*heads, sq, sk] (bias_per_bh).  lse: the forward's f32
// [batch*heads, sq]; delta: f32 scratch of the same shape.  dq: contiguous
// [batch*heads, sq, d]; dk, dv: contiguous [batch*heads, sk, d], in the
// inputs' dtype.  Launches two kernels (dq, which writes delta, then
// dk/dv) on `stream` without synchronising; returns the
// first cudaError_t of the launches (cudaErrorInvalidValue also when the
// driver refuses a tensor map).
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
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
#define TLX_LAUNCH(D)                                                       \
  return launch_bf16<D>(q, k, v, o, dout, b, l, dl, dq, dk, dv, batch,      \
                        heads, sq, sk, st, bs, scale, cs)
    switch (d) {
      case 32: TLX_LAUNCH(32);
      case 64: TLX_LAUNCH(64);
      case 96: TLX_LAUNCH(96);
      case 128: TLX_LAUNCH(128);
    }
#undef TLX_LAUNCH
  } else {
#define TLX_LAUNCH(D)                                                       \
  return launch_f32<D>(q, k, v, o, dout, b, l, dl, dq, dk, dv, batch,      \
                       heads, sq, sk, st, bs, scale, cs)
    switch (d) {
      case 32: TLX_LAUNCH(32);
      case 64: TLX_LAUNCH(64);
      case 96: TLX_LAUNCH(96);
      case 128: TLX_LAUNCH(128);
    }
#undef TLX_LAUNCH
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tlx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
