// What flash_attention.cu (the forward) and flash_attention_bwd.cu (its
// gradient) share on the bf16 path: the bias clamp, exponentials in log2
// units, bf16 packing, and TMA tiles of the (D, S, H, B) views that q, k,
// v, o and dO are read through.  Header only (_build compiles only *.cu).
//
// A tile is `rows` rows of one (batch, head) in boxes of 32 head-dim
// columns (64 bytes, which divide every head dim: 32, 64, 96, 128), each
// box stored with TMA's 64-byte swizzle: the K-major layout wgmma reads
// for Q K^T and the MN-major one it reads for P V.  Rows past the view's
// length are zero-filled by TMA; the kernels also exclude them explicitly.

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

// A 4D map over the (D, S, H, B) view of a bf16 tensor with element
// strides st = (batch, head, row), in boxes of 32 columns x `rows` rows;
// `s` is the tensor's own length (Sq for q, o and dO, Sk for k and v), so
// TMA zero-fills the rows past it.
// The dims are listed by growing stride (H before S for a packed qkv view,
// whose head stride is below its row stride): *swap says which.
inline bool make_view_map(CUtensorMap* map, const void* base,
                          const long long* st, int batch, int heads, int s,
                          int d, int rows, bool* swap) {
  const long long bs = batch == 1 ? (st[1] * heads + st[2] * s) : st[0];
  *swap = st[1] < st[2];
  const cuuint64_t e = 2;  // bytes of a bf16
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
  return make_bf16_map(map, base, 4, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace tlx
