// What flash_attention.cu (the forward) and flash_attention_bwd.cu (its
// gradient) share: the bias clamp, exponentials in log2 units, bf16
// packing, TMA tiles of the (D, S, H, B) views that q, k, v, o and dO are
// read through, and the f32 path's split-TF32 operands.  Header only
// (_build compiles only *.cu).
//
// A tile is `rows` rows of one (batch, head) in boxes of 32 head-dim
// columns, which divide every head dim (32, 64, 96, 128).  bf16: boxes of
// 64 bytes in TMA's 64-byte swizzle, the K-major layout wgmma reads for
// Q K^T and the MN-major one it reads for P V.  f32: boxes of 128 bytes in
// TMA's 128-byte swizzle ("direct" tiles, K-major along the head dim).
// Rows past the view's length are zero-filled by TMA; the kernels also
// exclude them explicitly.
//
// f32 on the tensor cores ("split TF32", the 3xTF32 of CUTLASS's fast-f32
// GEMMs): a TF32 product keeps 10 mantissa bits of each operand, about
// three digits, short of the f32 bound of 1e-4.  Each operand x is split
// into big = rna_tf32(x) (cvt.rna.tf32.f32) and small = x - big, exact in
// f32 (big + small == x), of which the tensor core reads the top 19 bits;
// a b is summed in f32 as a_small b_big + a_big b_small + a_big b_big, the
// small terms first: within about 2^-20 of an f32 product (|small| <=
// 2^-11 |x|, read to 10 bits; the dropped a_small b_small is below 2^-22).  tf32 wgmma has no
// transpose bit, so an operand whose reduction runs along the stored
// rows (K for dQ = dS K, V for O = P V, Q and dO for dK and dV) gets a
// transposed copy ("T" tiles: one row per head-dim column, one column per
// streamed row), written with its split in one pass by the threads that
// split the direct tile.  Register A operands (P, dS and their
// transposes) come from the m64nN accumulator, whose thread holds columns
// 2t and 2t + 1 of each group of 8, while the tf32 A fragment wants
// columns t and t + 4: the reduction order within each group of 8 is
// permuted instead (fragment column t <-> stored column 2t, t + 4 <->
// 2t + 1), and the T tiles store their columns in that order, so no
// register moves between threads.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tlx {

constexpr float kNeg = -0.7f * 3.402823466e38f;  // -0.7 * FLT_MAX
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kChunk = 32;  // head-dim columns per TMA box: 64 bytes

// 2^x on the special-function unit, subnormal results flushed to 0 (a
// probability below 2^-126 adds nothing at bf16 or f32 precision here).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&t);
}

// A box of `rows` rows x 32 columns of the (D, S, H, B) view at (col, row,
// h, b); `swap` says the map lists H before S (the smaller stride first).
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, bool swap, int col,
                                          int row, int h, int b) {
  if (swap)
    tma_load_4d(dst, map, bar, col, h, row, b);
  else
    tma_load_4d(dst, map, bar, col, row, h, b);
}

// A 4D map over the (D, S, H, B) view of a bf16 (or, with `f32`, f32)
// tensor with element strides st = (batch, head, row), in boxes of 32
// columns x `rows` rows; `s` is the tensor's own length (Sq for q, o and
// dO, Sk for k and v), so TMA zero-fills the rows past it.
// The dims are listed by growing stride (H before S for a packed qkv view,
// whose head stride is below its row stride): *swap says which.
inline bool make_view_map(CUtensorMap* map, const void* base,
                          const long long* st, int batch, int heads, int s,
                          int d, int rows, bool* swap, bool f32 = false) {
  const long long bs = batch == 1 ? (st[1] * heads + st[2] * s) : st[0];
  *swap = st[1] < st[2];
  const cuuint64_t e = f32 ? 4 : 2;  // bytes of an element
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(d),
      static_cast<cuuint64_t>(*swap ? heads : s),
      static_cast<cuuint64_t>(*swap ? s : heads),
      static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      e * static_cast<cuuint64_t>(*swap ? st[1] : st[2]),
      e * static_cast<cuuint64_t>(*swap ? st[2] : st[1]),
      e * static_cast<cuuint64_t>(bs)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kChunk),
                             static_cast<cuuint32_t>(*swap ? 1 : rows),
                             static_cast<cuuint32_t>(*swap ? rows : 1), 1};
  if (f32)
    return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, 4,
                           dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  return make_bf16_map(map, base, 4, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_64B);
}

// ------------------------------------------------------ f32: split TF32
constexpr int kF32Rows = 64;       // a block's resident rows (wgmma's M)
constexpr int kF32Threads = 256;   // consumer warpgroup + producer warpgroup

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// The f32 kernels' mbarriers after `at`: the resident tile loaded by TMA
// and split, then per raw stage loaded, and per operand stage split (full)
// and released (empty).
struct F32Bars {
  uint32_t res_load, res_ready, raw, full, empty;
  __device__ F32Bars(uint32_t at, int raws, int stages)
      : res_load(at), res_ready(at + 8), raw(at + 16),
        full(at + 16 + 8 * raws), empty(at + 16 + 8 * raws + 8 * stages) {}
  __device__ void init(int raws, int stages) const {
    mbar_init(res_load, 1);
    mbar_init(res_ready, 128);  // every producer thread's split
    for (int r = 0; r < raws; ++r) mbar_init(raw + 8 * r, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 128);
      mbar_init(empty + 8 * s, 4);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
};

// Byte offset of element (r, c) of a direct tile of R rows: boxes of 32
// columns R * 128 bytes apart, 16-byte chunks swizzled by r % 8.
template <int R>
__device__ __forceinline__ int dir_off(int r, int c) {
  return (c >> 5) * (R * 128) + ((r * 128 + (c & 31) * 4) ^ ((r & 7) << 4));
}

// Byte offset of (row d, stored column l) of a T tile of NS columns: rows
// of NS * 4 bytes in the swizzle of that width (NS = 32 or 16: 128- or
// 64-byte swizzle).
template <int NS>
__device__ __forceinline__ int tr_off(int d, int l) {
  constexpr int W = NS * 4;
  const int o = d * W + l * 4;
  return o ^ (((o >> 7) & (W / 16 - 1)) << 4);
}

// A K-major wgmma operand: k8 step `ks` (along the head dim) of a direct
// tile of R rows.
template <int R>
__device__ __forceinline__ uint64_t desc_dir(uint32_t tile, int ks) {
  return smem_desc(tile + (ks >> 2) * (R * 128) + (ks & 3) * 32, 16, 1024,
                   kSwizzle128B);
}

// A K-major wgmma B operand of N = D rows: k8 step `kk` (along the
// streamed rows) of a T tile of NS columns.
template <int NS>
__device__ __forceinline__ uint64_t desc_tr(uint32_t tile, int kk) {
  static_assert(NS == 32 || NS == 16, "T tiles of 32 or 16 columns");
  return smem_desc(tile + kk * 32, 16, 8 * NS * 4,
                   NS == 32 ? kSwizzle128B : kSwizzle64B);
}

// d (+)= A B to f32 accuracy from the split parts of both operands in
// shared memory (descriptors of the big parts and of the small ones).
template <int N>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], uint64_t a_big,
                                        uint64_t a_small, uint64_t b_big,
                                        uint64_t b_small, int scale_d) {
  wgmma_ss_tf32<N>(d, a_small, b_big, scale_d);
  wgmma_ss_tf32<N>(d, a_big, b_small, 1);
  wgmma_ss_tf32<N>(d, a_big, b_big, 1);
}

// The same with A's parts in registers.
template <int N>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2],
                                        const uint32_t (&a_big)[4],
                                        const uint32_t (&a_small)[4],
                                        uint64_t b_big, uint64_t b_small) {
  wgmma_rs_tf32<N>(d, a_small, b_big, 1);
  wgmma_rs_tf32<N>(d, a_big, b_small, 1);
  wgmma_rs_tf32<N>(d, a_big, b_big, 1);
}

// The split A fragments of k8 step kk from accumulator columns [8 kk,
// 8 kk + 8) (x[4 kk + e]: row lane/4 (+8 for e >= 2), column 8 kk + 2 t +
// (e & 1)), in the permuted column order of the T tiles.
__device__ __forceinline__ void split_frag(const float* x, uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
  const int from[4] = {0, 2, 1, 3};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float b = tf32_rna(x[from[r]]);
    big[r] = __float_as_uint(b);
    small[r] = __float_as_uint(x[from[r]] - b);
  }
}

__device__ __forceinline__ void split4(float4 x, float4& big, float4& small) {
  big = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                    tf32_rna(x.w));
  small = make_float4(x.x - big.x, x.y - big.y, x.z - big.z, x.w - big.w);
}

__device__ __forceinline__ float4& at4(unsigned char* base, int off) {
  return *reinterpret_cast<float4*>(base + off);
}

// Stored column of the T tile for streamed row r: in each group of 8 the
// even rows first, then the odd ones.
__device__ __forceinline__ int perm_col(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

// Writes a 4 x 4 block transposed into a T tile: row i of big / small
// (4 streamed rows' 4 columns) becomes stored column i of T rows o0..o3
// (their byte offsets), big at tb, small at tb + tsmall_off.
__device__ __forceinline__ void store_t4(unsigned char* tb, int tsmall_off,
                                         int o0, int o1, int o2, int o3,
                                         const float4 (&big)[4],
                                         const float4 (&small)[4]) {
  at4(tb, o0) = make_float4(big[0].x, big[1].x, big[2].x, big[3].x);
  at4(tb, o1) = make_float4(big[0].y, big[1].y, big[2].y, big[3].y);
  at4(tb, o2) = make_float4(big[0].z, big[1].z, big[2].z, big[3].z);
  at4(tb, o3) = make_float4(big[0].w, big[1].w, big[2].w, big[3].w);
  at4(tb, o0 + tsmall_off) =
      make_float4(small[0].x, small[1].x, small[2].x, small[3].x);
  at4(tb, o1 + tsmall_off) =
      make_float4(small[0].y, small[1].y, small[2].y, small[3].y);
  at4(tb, o2 + tsmall_off) =
      make_float4(small[0].z, small[1].z, small[2].z, small[3].z);
  at4(tb, o3 + tsmall_off) =
      make_float4(small[0].w, small[1].w, small[2].w, small[3].w);
}

// Splits a direct tile of R rows x D columns at `src` (as TMA stored it)
// into its big part at `t` (`src` itself: in place) and its small part at
// t + small_off; with kTrans both parts also transposed into the T tile at
// tb (big) and tb + tsmall_off.  `pt` is the thread's index among the 128
// that share the work; each takes blocks of 4 rows (r0, r0 + 2, r0 + 4,
// r0 + 6) x 4 columns, which are one 16-byte chunk of 4 stored columns in
// each of 4 rows of the T tile.
template <int R, int D, bool kTrans>
__device__ __forceinline__ void split_tile(unsigned char* src,
                                           unsigned char* t, int small_off,
                                           unsigned char* tb, int tsmall_off,
                                           int pt) {
  constexpr int kBlocks = R * D / 16;
#pragma unroll
  for (int blk = pt; blk < kBlocks; blk += 128) {
    const int dc = blk % (D / 4), kq = blk / (D / 4);
    const int r0 = 8 * (kq >> 1) + (kq & 1);
    float4 big[4], small[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = dir_off<R>(r0 + 2 * i, 4 * dc);
      split4(at4(src, off), big[i], small[i]);
      at4(t, off) = big[i];
      at4(t, off + small_off) = small[i];
    }
    if constexpr (kTrans) {
      const int c = perm_col(r0);  // stored columns c .. c + 3
      store_t4(tb, tsmall_off, tr_off<R>(4 * dc, c), tr_off<R>(4 * dc + 1, c),
               tr_off<R>(4 * dc + 2, c), tr_off<R>(4 * dc + 3, c), big,
               small);
    }
  }
}

// The transposed split alone, of a direct tile of R rows x D columns that
// TMA stored at `t`, into the T tile at the same place (big) and at
// t + tsmall_off (small): every thread reads its blocks first, then the
// 128 threads meet at named barrier `bar` before any writes.
template <int R, int D>
__device__ __forceinline__ void split_transpose_in_place(unsigned char* t,
                                                         int tsmall_off,
                                                         int pt, int bar) {
  constexpr int kBlocks = R * D / 16, kPer = (kBlocks + 127) / 128;
  float4 x[kPer][4];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int blk = pt + 128 * j;
    if (blk < kBlocks) {
      const int dc = blk % (D / 4), kq = blk / (D / 4);
      const int r0 = 8 * (kq >> 1) + (kq & 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[j][i] = at4(t, dir_off<R>(r0 + 2 * i, 4 * dc));
    }
  }
  named_barrier(bar, 128);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int blk = pt + 128 * j;
    if (blk < kBlocks) {
      const int dc = blk % (D / 4), kq = blk / (D / 4);
      const int c = perm_col(8 * (kq >> 1) + (kq & 1));
      float4 big[4], small[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split4(x[j][i], big[i], small[i]);
      store_t4(t, tsmall_off, tr_off<R>(4 * dc, c), tr_off<R>(4 * dc + 1, c),
               tr_off<R>(4 * dc + 2, c), tr_off<R>(4 * dc + 3, c), big,
               small);
    }
  }
}

}  // namespace tlx
