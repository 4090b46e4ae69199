// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel tlxcv_tpu/ops/pallas/attention.py
// (`flash_attention` :108, kernel `_kernel` :39).  Same function:
//   out = softmax(q k^T * scale + bias) v
//   q, out: [BH, Sq, D]; k, v: [BH, Sk, D]; bias: [1 or BH, Sq, Sk]
// with the bias added in f32 and clamped at -0.7 * FLT_MAX, key columns at
// or past Sk excluded, softmax statistics and the accumulator in f32, P
// cast to v's dtype before P.V, and the output in q's dtype.  The TPU
// kernel takes one S for queries and keys; this one takes its own key
// length (DETR's cross-attention: 100 queries over H*W keys): query tiles
// and row guards run over Sq, the key-tile loop, the k and v tensor maps
// and the key-column mask over Sk, and bias rows have stride Sk.
//
// What bounds it: at ViT-B/16 shapes (BH = 12 * batch, S = 197, D = 64) a
// call does 4*S*S*D*BH operations on 4*BH*S*D elements, about 100 bf16
// operations per byte moved, well below the H100's ~295 at which the tensor
// cores, not memory, become the limit.  So the bound is the bytes of q, k,
// v and o.  The design reads each q tile once, streams k and v tiles
// through shared memory, and keeps the Sq x Sk scores and probabilities in
// registers: the only device-memory traffic is q, k, v and o, with k and v
// read again from L2 by a head's other query tiles.  DETR-R50's encoder
// (Sq = Sk = 1050, D = 32) does about 520 operations per byte and is bound
// by the tensor cores; its cross-attention (Sq = 100, Sk = 1050) by bytes.
//
// bf16 design (warp-specialised, TMA + wgmma):
// - one block per (bh, tile of 64 query rows), the query tiles of one head
//   next to each other in the grid, so a head's k and v come from L2 after
//   its first tile; 160 threads: one consumer warpgroup of 64 rows (wgmma's
//   M) and one producer warp (kRowsQ below says why not two);
// - the producer's one thread loads the q tile once and the 64-key k and v
//   tiles into a 2-stage ring by TMA, through 4D tensor maps over the
//   strided (D, S, H, B) views (so a ViT block's packed qkv projection is
//   read in place), in boxes of 32 columns (64 bytes, which divide every
//   head dim: 32, 64, 96, 128) stored with TMA's 64-byte swizzle;
//   out-of-range rows are zero-filled by TMA; per stage a full barrier for
//   k, one for v, and an empty barrier the consumers release;
// - S = Q K^T by wgmma m64n64k16 from shared memory (both K-major); the
//   online softmax stays in registers, in the accumulator layout; P is
//   rounded to bf16 in registers and is wgmma's register A operand for
//   O += P V (m64nDk16, V MN-major from shared memory), so neither S nor P
//   touches shared memory;
// - the bias, whose rows (4 S bytes) TMA cannot address, is read with
//   plain loads; o is stored from registers through its strides (ViT's
//   token-major layout), rows past Sq skipped;
// - rows past Sq and keys past Sk are computed as padding (at S = 197:
//   256 of each); skipping a warp's dead rows, key groups or k16 steps in
//   the last tile measured slower at ViT's shape and is left out;
// - the exponentials run on the special-function unit in log2 units
//   (ex2.approx.ftz; without bias, log2(e) is folded into the scale);
// - up to four blocks share an SM at D = 64 (41 KB of shared memory, 160
//   threads of 92 registers each), so one block's loads and epilogue
//   overlap the others' products.
// f32 design (flash_attention.cuh's split TF32 on the same tensor cores):
// - what bounds it: the products run as three TF32 products each, at a
//   third of the card's 495 TFLOP/s TF32 rate, so at TrOCR's encoder grid
//   (BH = 192, S = 577, D = 64) the operations take 0.099 ms against
//   0.034 ms for the f32 bytes of q, k, v and o (S / 4 operations a byte);
//   below S of about 200 (49 operations a byte) the bytes bound it.  The design keeps the tensor cores on the
//   products and moves the f32 split off their path;
// - one block per (bh, tile of 64 query rows) and 256 threads: a consumer
//   warpgroup (wgmma's M = 64 rows) and a producer warpgroup.  The
//   producer's thread loads q once and 32-key k and v tiles into a
//   2-stage ring by TMA (f32 boxes of 32 columns, 128-byte swizzle); its
//   128 threads then split each tile in shared memory: q and k in place
//   into big parts, small parts beside them; v, which O = P V reads along
//   its rows, into a T tile (its transpose, big and small) in the place
//   TMA loaded it, all threads reading before any writes;
// - S = Q K^T by m64n32k8 wgmmas from shared memory, three a k8 step
//   (small terms first); the online softmax on the accumulator as the
//   bf16 path; P split in registers (cvt.rna.tf32) into wgmma's A
//   fragments in the T tiles' permuted column order; O += P V by m64nDk8
//   wgmmas from registers and V's T tile;
// - up to D = 64 two blocks share an SM (97 KB of shared memory each), so
//   one block's softmax overlaps the other's products.
// Both paths: online softmax per row, rescaled per k/v tile and normalised
// once at the end (equal in exact arithmetic to the TPU kernel's per-step
// rescale); columns past Sk get probability exactly 0, so a row whose every
// real key is masked averages v over its Sk keys and stays finite.  When
// the caller passes an lse pointer (a training forward) each row's
// log-sum-exp m + log(l) is written there for flash_attention_bwd.cu;
// serving passes null and writes nothing more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

using namespace tlx;

// Element strides of (batch, head, row) for q, k, v and o; the head dim is
// contiguous.  q, k and v can be strided views into the packed qkv
// projection, and o can be written token-major, with no copies around the
// kernel.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// ---------------------------------------------------------------- f32 path
// Per block: the 64 query rows' Q split once (big, small), and a 2-stage
// ring of 32-key stages, each K split (big, small) and V's T tile (big,
// small).
template <int D>
struct F32Layout {
  static constexpr int kKeys = 32;
  static constexpr int kStages = 2;
  static constexpr int kQPart = kF32Rows * D * 4;
  static constexpr int kPart = kKeys * D * 4;  // one part of K or of V^T
  static constexpr int kRing = 2 * kQPart;
  static constexpr int kStage = 4 * kPart;      // K big, small, V^T big, small
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (2 + 3 * kStages);
  static_assert(kSmem <= 232448, "shared memory of a block");
};

// Up to D = 64 two blocks share an SM (97 KB each at D = 64), capping a
// thread at 128 registers.
template <int D, bool kBias>
__global__ void __launch_bounds__(kF32Threads, D <= 64 ? 2 : 1)
flash_fwd_f32(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const float* __restrict__ bias, float* __restrict__ o,
              float* __restrict__ lse, int Sq, int Sk, int H, long long o_b,
              long long o_h, long long o_row, long long bias_bh_stride,
              float scale, int swaps) {
  using L = F32Layout<D>;
  constexpr int NS = L::kKeys, S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* base = smem_raw + (sq - smem_u32(smem_raw));
  const uint32_t ring = sq + L::kRing;
  const F32Bars bars(sq + L::kBars, S, S);  // q as the resident tile

  const int n_qt = (Sq + kF32Rows - 1) / kF32Rows;
  const int bh = blockIdx.x / n_qt;  // a head's query tiles are adjacent
  const int q0 = (blockIdx.x % n_qt) * kF32Rows;
  const int b = bh / H, h = bh % H;
  const int n_kv = (Sk + NS - 1) / NS;

  if (threadIdx.x == 0) bars.init(S, S);
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ------------------------------- producer warpgroup: TMA, then split
    const int pt = threadIdx.x - 128;
    if (pt == 0) {
      mbar_expect_tx(bars.res_load, L::kQPart);
#pragma unroll
      for (int c = 0; c < D / kChunk; ++c)
        load_rows(sq + c * (kF32Rows * 128), &map_q, bars.res_load,
                  swaps & 1, c * kChunk, q0, h, b);
    }
    mbar_wait(bars.res_load, 0);
    split_tile<kF32Rows, D, false>(base, base, L::kQPart, nullptr, 0,
                                   pt);
    fence_proxy_async();
    mbar_arrive(bars.res_ready);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % S;
      const uint32_t sk = ring + s * L::kStage;
      const uint32_t sv = sk + 2 * L::kPart;  // V lands in its T tile's place
      if (pt == 0) {
        mbar_wait(bars.empty + 8 * s, ((j / S) & 1) ^ 1);
        mbar_expect_tx(bars.raw + 8 * s, 2 * L::kPart);
#pragma unroll
        for (int c = 0; c < D / kChunk; ++c) {
          load_rows(sk + c * (NS * 128), &map_k, bars.raw + 8 * s,
                    swaps & 2, c * kChunk, j * NS, h, b);
          load_rows(sv + c * (NS * 128), &map_v, bars.raw + 8 * s,
                    swaps & 4, c * kChunk, j * NS, h, b);
        }
      }
      mbar_wait(bars.raw + 8 * s, (j / S) & 1);
      unsigned char* st = base + (sk - sq);
      split_tile<NS, D, false>(st, st, L::kPart, nullptr, 0, pt);
      split_transpose_in_place<NS, D>(st + 2 * L::kPart, L::kPart, pt, 1);
      fence_proxy_async();
      mbar_arrive(bars.full + 8 * s);
    }
    return;
  }
  // ----------------------------------------------------------- consumers
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int row0 = q0 + threadIdx.x / 32 * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const float* br0 = nullptr;
  const float* br1 = nullptr;
  if (kBias) {
    const float* bb = bias + bh * bias_bh_stride;
    br0 = bb + static_cast<long long>(min(row0, Sq - 1)) * Sk;
    br1 = bb + static_cast<long long>(min(row1, Sq - 1)) * Sk;
  }
  // as the bf16 path: log2 units without bias, natural units with one
  const float sc = kBias ? scale : scale * kLog2e;

  float sacc[NS / 2];  // S: rows (row0, row1) x 32 keys
  float oacc[D / 2];   // O: rows (row0, row1) x D
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows row0, row1
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the sums
  uint32_t pb[NS / 8][4], ps[NS / 8][4];  // P's split A fragments

  mbar_wait(bars.res_ready, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % S;
    const uint32_t sk = ring + s * L::kStage;
    const uint32_t svt = sk + 2 * L::kPart;
    const int k0 = j * NS;

    // S = Q K^T: per k8 step along the head dim, three TF32 products
    mbar_wait(bars.full + 8 * s, (j / S) & 1);
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
      mma3_ss<NS>(sacc, desc_dir<kF32Rows>(sq, ks),
                  desc_dir<kF32Rows>(sq + L::kQPart, ks),
                  desc_dir<NS>(sk, ks), desc_dir<NS>(sk + L::kPart, ks),
                  ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // online softmax on the accumulator: sacc[4 jj + e] is row row0 (e < 2)
    // or row1, key k0 + 8 jj + 2 t + (e & 1)
    float mt0 = -INFINITY, mt1 = -INFINITY;
    const bool ragged = k0 + NS > Sk;
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {
      const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      float x;
      if (kBias) {
        const float* br = (i & 2) ? br1 : br0;
        x = fmaxf(fmaf(sacc[i], sc, col < Sk ? br[col] : 0.f), kNeg);
      } else {
        x = sacc[i] * sc;
      }
      if (ragged && col >= Sk) x = -INFINITY;
      sacc[i] = x;
      if (i & 2)
        mt1 = fmaxf(mt1, x);
      else
        mt0 = fmaxf(mt0, x);
    }
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    const float u = kBias ? kLog2e : 1.f;
    const float a0 = exp2_ftz((m0 - mn0) * u);
    const float a1 = exp2_ftz((m1 - mn1) * u);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {
      const float p = exp2_ftz((sacc[i] - ((i & 2) ? m1 : m0)) * u);
      if (i & 2)
        l1 += p;
      else
        l0 += p;
      sacc[i] = p;
    }
#pragma unroll
    for (int kk = 0; kk < NS / 8; ++kk) split_frag(sacc + 4 * kk, pb[kk], ps[kk]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= (i & 2) ? a1 : a0;

    // O += P V: per k8 step along the keys, three TF32 products, B from
    // V's T tile
    fence_regs(oacc);
    fence_regs(pb);
    fence_regs(ps);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 8; ++kk)
      mma3_rs<D>(oacc, pb[kk], ps[kk], desc_tr<NS>(svt, kk),
                 desc_tr<NS>(svt + L::kPart, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    if (lane == 0) mbar_arrive(bars.empty + 8 * s);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (lse != nullptr && t == 0) {
    const float mu = kBias ? 1.f : kLn2;
    float* lr = lse + static_cast<long long>(bh) * Sq;
    if (row0 < Sq) lr[row0] = m0 * mu + log2f(l0) * kLn2;
    if (row1 < Sq) lr[row1] = m1 * mu + log2f(l1) * kLn2;
  }
  float* ob = o + b * o_b + h * o_h;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<float2*>(ob + row0 * o_row + col) =
          make_float2(oacc[4 * jj] * inv0, oacc[4 * jj + 1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<float2*>(ob + row1 * o_row + col) =
          make_float2(oacc[4 * jj + 2] * inv1, oacc[4 * jj + 3] * inv1);
  }
}

template <int D, bool kBias>
cudaError_t launch_f32_kind(const CUtensorMap* maps, const float* bias,
                            void* o, float* lse, int bh, int sq, int sk,
                            int heads, const Strides& st,
                            long long bias_bh_stride, float scale, int swaps,
                            cudaStream_t stream) {
  constexpr size_t smem = F32Layout<D>::kSmem;
  static cudaError_t err = cudaFuncSetAttribute(  // once per process
      flash_fwd_f32<D, kBias>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(bh) * ((sq + kF32Rows - 1) / kF32Rows);
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  flash_fwd_f32<D, kBias><<<static_cast<unsigned>(blocks), kF32Threads, smem,
                            stream>>>(
      maps[0], maps[1], maps[2], bias, static_cast<float*>(o), lse, sq, sk,
      heads, st.o[0], st.o[1], st.o[2], bias_bh_stride, scale, swaps);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const float* bias, void* o, float* lse, int batch,
                       int heads, int sq, int sk, const Strides& st,
                       long long bias_bh_stride, float scale,
                       cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const long long* strides[3] = {st.q, st.k, st.v};
  int swaps = 0;
  for (int i = 0; i < 3; ++i) {
    bool swap;
    if (!make_view_map(&maps[i], bases[i], strides[i], batch, heads,
                       i == 0 ? sq : sk, D,
                       i == 0 ? kF32Rows : F32Layout<D>::kKeys, &swap, true))
      return cudaErrorInvalidValue;
    swaps |= swap << i;
  }
  const int bh = batch * heads;
  if (bias != nullptr)
    return launch_f32_kind<D, true>(maps, bias, o, lse, bh, sq, sk, heads, st,
                                    bias_bh_stride, scale, swaps, stream);
  return launch_f32_kind<D, false>(maps, bias, o, lse, bh, sq, sk, heads, st,
                                   bias_bh_stride, scale, swaps, stream);
}


// --------------------------------------------------------------- bf16 path
// Query rows per block: one consumer warpgroup of 64 rows (wgmma's M).
// Two warpgroups a block (128 rows) measured slower at every shape of
// chip_smoke.py's kernel cases on the H100: four independent blocks an
// SM hide each other's prologue better than two blocks of two.
constexpr int kRowsQ = 64;
constexpr int kKeys = 64;     // keys per k/v tile
constexpr int kStages = 2;
constexpr int kThreadsBf16 = 160;  // the consumer warpgroup + 1 producer warp

template <int D>
struct Layout {
  static constexpr int kChunks = D / kChunk;
  static constexpr int kQChunk = kRowsQ * kChunk * 2;
  static constexpr int kKVChunk = kKeys * kChunk * 2;   // 4 KB
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kTileBytes = kChunks * kKVChunk;  // one k or v tile
  static constexpr int kStageBytes = 2 * kTileBytes;     // k, then v
  // barriers: q, k full x kStages, v full x kStages, empty x kStages
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 3 * kStages);
};

// No minimum of blocks an SM: a register cap made the bias variants spill
// and gained nothing at ViT's shape, where blocks of 92 registers share an
// SM anyway.
template <int D, bool kBias>
__global__ void __launch_bounds__(kThreadsBf16, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk, int H, long long o_b,
               long long o_h,
               long long o_row,
               long long bias_bh_stride, float scale, int swaps) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = sq + L::kQBytes;
  const uint32_t bar_q = sq + L::kBarOffset;
  const uint32_t bar_k = bar_q + 8;                  // + 8 s
  const uint32_t bar_v = bar_k + 8 * kStages;        // + 8 s
  const uint32_t bar_empty = bar_v + 8 * kStages;    // + 8 s

  const int n_qt = (Sq + kRowsQ - 1) / kRowsQ;
  const int bh = blockIdx.x / n_qt;  // a head's query tiles are adjacent
  const int q0 = (blockIdx.x % n_qt) * kRowsQ;
  const int b = bh / H, h = bh % H;
  const int n_kv = (Sk + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x != 128) return;
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      load_rows(sq + c * L::kQChunk, &map_q, bar_q, swaps & 1, c * kChunk, q0,
                h, b);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kStages;
      mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
      const uint32_t sk = ring + s * L::kStageBytes;
      const uint32_t sv = sk + L::kTileBytes;
      mbar_expect_tx(bar_k + 8 * s, L::kTileBytes);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
        load_rows(sk + c * L::kKVChunk, &map_k, bar_k + 8 * s, swaps & 2,
                  c * kChunk, j * kKeys, h, b);
      mbar_expect_tx(bar_v + 8 * s, L::kTileBytes);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
        load_rows(sv + c * L::kKVChunk, &map_v, bar_v + 8 * s, swaps & 4,
                  c * kChunk, j * kKeys, h, b);
    }
    return;
  }
  // ----------------------------------------------------------- consumers
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int row0 = q0 + threadIdx.x / 32 * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const float* br0 = nullptr;
  const float* br1 = nullptr;
  if (kBias) {
    const float* bb = bias + bh * bias_bh_stride;
    br0 = bb + static_cast<long long>(min(row0, Sq - 1)) * Sk;
    br1 = bb + static_cast<long long>(min(row1, Sq - 1)) * Sk;
  }
  // without bias the scores are kept in log2 units (scaled by scale*log2e);
  // with bias in natural units, since the clamp value times log2e would
  // overflow to -inf
  const float sc = kBias ? scale : scale * kLog2e;

  float sacc[kKeys / 2];  // S: rows (row0, row1) x 64 keys
  float oacc[D / 2];      // O: rows (row0, row1) x D
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows row0, row1
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the sums

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    const uint32_t phase = (j / kStages) & 1;
    const uint32_t sk = ring + s * L::kStageBytes;
    const uint32_t sv = sk + L::kTileBytes;
    const int k0 = j * kKeys;

    // S = Q K^T: k16 steps along the head dim, two per 32-column chunk
    mbar_wait(bar_k + 8 * s, phase);
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks & 1) * 32;
      wgmma_ss<kKeys, 0>(
          sacc,
          smem_desc(sq + (ks >> 1) * L::kQChunk + off, 16, 512, kSwizzle64B),
          smem_desc(sk + (ks >> 1) * L::kKVChunk + off, 16, 512, kSwizzle64B),
          ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // online softmax on the accumulator: sacc[4 jj + e] is row row0 (e < 2)
    // or row1, key k0 + 8 jj + 2 t + (e & 1)
    float mt0 = -INFINITY, mt1 = -INFINITY;
    const bool ragged = k0 + kKeys > Sk;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      float x;
      if (kBias) {
        const float* br = (i & 2) ? br1 : br0;
        x = fmaxf(fmaf(sacc[i], sc, col < Sk ? br[col] : 0.f), kNeg);
      } else {
        x = sacc[i] * sc;
      }
      if (ragged && col >= Sk) x = -INFINITY;
      sacc[i] = x;
      if (i & 2)
        mt1 = fmaxf(mt1, x);
      else
        mt0 = fmaxf(mt0, x);
    }
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    // exp of a difference, in log2 units: the clamp value -0.7 FLT_MAX
    // minus itself is 0
    const float u = kBias ? kLog2e : 1.f;
    const float a0 = exp2_ftz((m0 - mn0) * u);
    const float a1 = exp2_ftz((m1 - mn1) * u);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
    uint32_t pa[kKeys / 16][4];  // P as the A fragments of 4 k16 steps
#pragma unroll
    for (int i = 0; i < kKeys / 2; i += 2) {
      const float mi = (i & 2) ? m1 : m0;
      const float p0 = exp2_ftz((sacc[i] - mi) * u);
      const float p1 = exp2_ftz((sacc[i + 1] - mi) * u);
      if (i & 2)
        l1 += p0 + p1;
      else
        l0 += p0 + p1;
      // key group jj = i / 4: A register (jj & 1) * 2 + (row1 ? 1 : 0) of
      // k16 step jj / 2
      pa[i / 8][((i / 4) & 1) * 2 + ((i & 2) ? 1 : 0)] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= (i & 2) ? a1 : a0;

    // O += P V: k16 steps along the keys, 16 rows (1024 bytes) of the
    // MN-major V tile each; 32-column chunks of V 4 KB apart (LBO)
    mbar_wait(bar_v + 8 * s, phase);
    fence_regs(oacc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs<D>(oacc, pa[kk],
                  smem_desc(sv + kk * 16 * (kChunk * 2), L::kKVChunk, 512,
                            kSwizzle64B),
                  1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    if (threadIdx.x % 128 == 0) mbar_arrive(bar_empty + 8 * s);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (lse != nullptr && t == 0) {
    // natural units: m is in log2 units without a bias, natural with one
    const float mu = kBias ? 1.f : kLn2;
    float* lr = lse + static_cast<long long>(bh) * Sq;
    if (row0 < Sq) lr[row0] = m0 * mu + log2f(l0) * kLn2;
    if (row1 < Sq) lr[row1] = m1 * mu + log2f(l1) * kLn2;
  }
  __nv_bfloat16* ob = o + b * o_b + h * o_h;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * o_row + col) =
          __floats2bfloat162_rn(oacc[4 * jj] * inv0, oacc[4 * jj + 1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * o_row + col) =
          __floats2bfloat162_rn(oacc[4 * jj + 2] * inv1,
                                oacc[4 * jj + 3] * inv1);
  }
}

template <int D, bool kBias>
cudaError_t launch_bf16_kind(const CUtensorMap* maps, const float* bias,
                             void* o, float* lse, int bh, int sq, int sk,
                             int heads, const Strides& st,
                             long long bias_bh_stride, float scale, int swaps,
                             cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kSmem;
  static cudaError_t err = cudaFuncSetAttribute(  // once per process
      flash_fwd_bf16<D, kBias>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(bh) * ((sq + kRowsQ - 1) / kRowsQ);
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  flash_fwd_bf16<D, kBias><<<static_cast<unsigned>(blocks), kThreadsBf16,
                             smem, stream>>>(
      maps[0], maps[1], maps[2], bias, static_cast<__nv_bfloat16*>(o), lse,
      sq, sk, heads, st.o[0], st.o[1], st.o[2], bias_bh_stride, scale, swaps);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const float* bias, void* o, float* lse, int batch,
                        int heads, int sq, int sk, const Strides& st,
                        long long bias_bh_stride, float scale,
                        cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const long long* strides[3] = {st.q, st.k, st.v};
  int swaps = 0;
  for (int i = 0; i < 3; ++i) {
    bool swap;
    if (!make_view_map(&maps[i], bases[i], strides[i], batch, heads,
                       i == 0 ? sq : sk, D, i == 0 ? kRowsQ : kKeys, &swap))
      return cudaErrorInvalidValue;
    swaps |= swap << i;
  }
  const int bh = batch * heads;
  if (bias != nullptr)
    return launch_bf16_kind<D, true>(maps, bias, o, lse, bh, sq, sk, heads,
                                     st, bias_bh_stride, scale, swaps,
                                     stream);
  return launch_bf16_kind<D, false>(maps, bias, o, lse, bh, sq, sk, heads, st,
                                    bias_bh_stride, scale, swaps, stream);
}

}  // namespace

// q, o: [batch, heads, sq, d] and k, v: [batch, heads, sk, d], given by
// element strides (12 values: batch, head and row strides of q, k, v, o in
// turn), the head dim contiguous; all f32 or all bf16 (is_bf16), every row
// 16-byte aligned, and for bf16 every stride a whole number of 16-byte
// units.  bias: null or contiguous f32 [1 or batch*heads, sq, sk]
// (bias_per_bh).  lse: null (serving) or f32 [batch*heads, sq], where the
// kernel writes each row's log-sum-exp of the clamped scores for the
// backward, in natural units (see flash_attention_bwd.cu).
// Launches on `stream` without synchronising; returns the cudaError_t of
// the launch (cudaErrorInvalidValue also when the driver refuses a tensor
// map).
extern "C" int tlx_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, void* lse, int batch,
                                       int heads, int sq, int sk, int d,
                                       const long long* strides,
                                       int bias_per_bh, float scale,
                                       int is_bf16, void* stream) {
  float* ls = static_cast<float*>(lse);
  const float* b = static_cast<const float*>(bias);
  const long long bs = bias_per_bh ? (long long)sq * sk : 0;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
#define TLX_LAUNCH(D) \
  return launch_bf16<D>(q, k, v, b, o, ls, batch, heads, sq, sk, st, bs, \
                        scale, cs)
    switch (d) {
      case 32: TLX_LAUNCH(32);
      case 64: TLX_LAUNCH(64);
      case 96: TLX_LAUNCH(96);
      case 128: TLX_LAUNCH(128);
    }
#undef TLX_LAUNCH
  } else {
#define TLX_LAUNCH(D) \
  return launch_f32<D>(q, k, v, b, o, ls, batch, heads, sq, sk, st, bs, \
                       scale, cs)
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
