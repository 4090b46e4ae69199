// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel tlxcv_tpu/ops/pallas/attention.py
// (`flash_attention` :108, kernel `_kernel` :39).  Same function:
//   out = softmax(q k^T * scale + bias) v        q, k, v, out: [BH, S, D]
// with the bias added in f32 and clamped at -0.7 * FLT_MAX, key columns at
// or past S excluded, softmax statistics and the accumulator in f32, P cast
// to v's dtype before P.V, and the output in q's dtype.
//
// What bounds it: at ViT-B/16 shapes (BH = 12 * batch, S = 197, D = 64) a
// call does 4*S*S*D*BH operations on 4*BH*S*D elements, about 100 bf16
// operations per byte moved, well below the H100's ~295 at which the tensor
// cores, not memory, become the limit.  So the bound is the bytes of q, k,
// v and o.  The design reads each q tile once, streams k and v tiles
// through shared memory, and keeps the S x S scores and probabilities in
// registers: the only device-memory traffic is q, k, v (k and v once per
// 64-row query tile) and o.
//
// Design (simple first; wgmma, TMA and warp specialisation come later):
// - one thread block per (bh, tile of 64 query rows); a loop inside the block
//   walks 64-row k/v tiles staged in shared memory (the TPU kernel's
//   sequential kv grid axis);
// - bf16: 4 warps, each owning 16 query rows.  Both products run on the
//   tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate).  The
//   scores' accumulator fragments are re-packed in registers as the A operand
//   of P.V, so P never touches shared memory.  K/V tiles are double-buffered
//   with cp.async, so the copy of the next tile overlaps the products of the
//   current one; V's fragments come from ldmatrix.trans of the row-major
//   tile.  Key tiles wholly past S, and warps whose rows all lie past S (at
//   S = 197 three of the last query tile's four), skip their products;
// - f32: the tensor cores would round to TF32, so this path runs on the f32
//   FMA units: 256 threads, four per query row, scores and P in shared memory;
// - q, k, v and o are addressed through (batch, head, row) strides, so a
//   ViT block's packed qkv projection feeds the kernel in place and o is
//   written token-major: no copies around the call;
// - online softmax per row, rescaled per k/v tile and normalised once at the
//   end (equal in exact arithmetic to the TPU kernel's per-step rescale);
// - columns past S get probability exactly 0, so a row whose every real key
//   is masked averages v over its S keys and stays finite.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -0.7f * 3.402823466e38f;  // -0.7 * FLT_MAX
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
static_assert(kBlockQ == kBlockK, "one row loader stages Q, K and V");

// Element strides of (batch, head, row) for q, k, v and o; the head dim is
// contiguous.  Block x of the grid is bh = batch * heads + head, so q, k and
// v can be strided views into the packed qkv projection, and o can be
// written token-major, with no copies around the kernel.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// ---------------------------------------------------------------- f32 path
constexpr int kThreadsF32 = 256;  // four threads per query row

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              float* __restrict__ o, int S, int H, Strides st,
              long long bias_bh_stride, float scale) {
  constexpr int LD = D + 1;         // padded rows: column reads hit 32 banks
  constexpr int PLD = kBlockK + 1;
  constexpr int NJ = kBlockK / 4;   // keys per thread in a tile
  constexpr int ND = D / 4;         // output dims per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);  // [kBlockQ][LD]
  float* sk = sq + kBlockQ * LD;               // [kBlockK][LD]
  float* sv = sk + kBlockK * LD;               // [kBlockK][LD]
  float* sp = sv + kBlockK * LD;               // [kBlockQ][PLD]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2;    // query row in the tile
  const int sub = tid & 3;   // which of the row's four threads
  const int b = bh / H, h = bh % H;
  const long long qo = b * st.q[0] + h * st.q[1];
  const long long ko = b * st.k[0] + h * st.k[1];
  const long long vo = b * st.v[0] + h * st.v[1];
  const long long oo = b * st.o[0] + h * st.o[1];
  const int qrow = q0 + r;
  const float* brow =
      bias ? bias + bh * bias_bh_stride + (size_t)min(qrow, S - 1) * S
           : nullptr;

  for (int i = tid; i < kBlockQ * D; i += kThreadsF32) {
    const int row = i / D, col = i % D, g = q0 + row;
    sq[row * LD + col] = g < S ? q[qo + g * st.q[2] + col] : 0.f;
  }

  float acc[ND];
#pragma unroll
  for (int dd = 0; dd < ND; ++dd) acc[dd] = 0.f;
  float m = -INFINITY, l = 0.f;  // running max; this thread's part of the sum

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBlockK * D; i += kThreadsF32) {
      const int row = i / D, col = i % D, g = k0 + row;
      const bool ok = g < S;
      sk[row * LD + col] = ok ? k[ko + g * st.k[2] + col] : 0.f;
      sv[row * LD + col] = ok ? v[vo + g * st.v[2] + col] : 0.f;
    }
    __syncthreads();

    float s[NJ];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) s[jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = sq[r * LD + d];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) s[jj] += qd * sk[(sub + 4 * jj) * LD + d];
    }
    float mt = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = k0 + sub + 4 * jj;
      float x = s[jj] * scale;
      if (brow) {
        if (col < S) x += brow[col];
        x = fmaxf(x, kNeg);
      }
      if (col >= S) x = -INFINITY;
      s[jj] = x;
      mt = fmaxf(mt, x);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    m = m_new;
    float ps = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float p = expf(s[jj] - m_new);
      ps += p;
      sp[r * PLD + sub + 4 * jj] = p;
    }
    l = l * alpha + ps;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) acc[dd] *= alpha;
    __syncwarp();  // a row's four threads share one warp
    for (int j = 0; j < kBlockK; ++j) {
      const float p = sp[r * PLD + j];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) acc[dd] += p * sv[j * LD + sub + 4 * dd];
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (qrow < S) {
    const float inv = 1.f / l;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd)
      o[oo + qrow * st.o[2] + sub + 4 * dd] = acc[dd] * inv;
  }
}

template <int D>
constexpr size_t smem_f32() {
  return (3 * kBlockQ * (D + 1) + kBlockQ * (kBlockK + 1)) * sizeof(float);
}

// --------------------------------------------------------------- bf16 path
constexpr int kThreadsBf16 = 128;  // four warps of 16 query rows

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16-byte global -> shared copy that bypasses registers; when !valid it
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four transposed 8x8 b16 tiles; lanes 8i..8i+7 give the row addresses of
// tile i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ o,
               int S, int H, Strides st, long long bias_bh_stride,
               float scale) {
  // Rows padded by 8 bf16 (16 bytes): a warp's 32-bit fragment reads and
  // ldmatrix row reads then fall on 32 distinct banks, and every row
  // starts 16-byte aligned for cp.async.
  constexpr int LD = D + 8;
  constexpr int VEC = 8;           // bf16 in one 16-byte copy
  constexpr int CPR = D / VEC;     // 16-byte chunks in a row
  constexpr int KS = D / 16;       // mma k-steps over the head dim
  constexpr int NT = kBlockK / 8;  // 8-key column tiles of the scores
  constexpr int DT = D / 8;        // 8-dim column tiles of the output
  constexpr int TILE = kBlockK * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  // Q tile, then two stages of (K tile, V tile): the next k/v tile is in
  // flight while the current one is used.
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* skv = sq + kBlockQ * LD;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int wr = (tid >> 5) * 16;  // the warp's first row in the tile
  const int lane = tid & 31;
  const int g = lane >> 2;         // fragment row (and row + 8)
  const int t = lane & 3;          // fragment column pair
  const int n_kv = (S + kBlockK - 1) / kBlockK;
  const int b = bh / H, h = bh % H;
  // src: the (batch, head) slice; ss: its row stride
  auto load_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src,
                       long long ss, int r0) {
    for (int i = tid; i < kBlockK * CPR; i += kThreadsBf16) {
      const int row = i / CPR, c = i % CPR, gr = r0 + row;
      const bool ok = gr < S;  // rows past S are zero-filled
      cp_async16(dst + row * LD + c * VEC, src + (ok ? gr : 0) * ss + c * VEC,
                 ok);
    }
  };
  const __nv_bfloat16* qs = q + b * st.q[0] + h * st.q[1];
  const __nv_bfloat16* ks = k + b * st.k[0] + h * st.k[1];
  const __nv_bfloat16* vs = v + b * st.v[0] + h * st.v[1];
  __nv_bfloat16* os = o + b * st.o[0] + h * st.o[1];
  load_rows(sq, qs, st.q[2], q0);
  load_rows(skv, ks, st.k[2], 0);
  load_rows(skv + TILE, vs, st.v[2], 0);
  cp_async_commit();

  const bool live = q0 + wr < S;  // the warp holds at least one real row
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const float* br0 =
      bias ? bias + bh * bias_bh_stride + (size_t)min(row0, S - 1) * S
           : nullptr;
  const float* br1 =
      bias ? bias + bh * bias_bh_stride + (size_t)min(row1, S - 1) * S
           : nullptr;
  uint32_t qa[KS][4];  // the warp's 16 query rows as mma A fragments
  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the sums

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBlockK;
    if (j + 1 < n_kv) {
      __nv_bfloat16* next = skv + ((j + 1) & 1) * 2 * TILE;
      load_rows(next, ks, st.k[2], k0 + kBlockK);
      load_rows(next + TILE, vs, st.v[2], k0 + kBlockK);
      cp_async_commit();
      cp_async_wait<1>();  // everything but the tile just requested
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* p0 = sq + (wr + g) * LD + ks * 16 + t * 2;
        const __nv_bfloat16* p1 = p0 + 8 * LD;
        qa[ks][0] = ld32(p0);
        qa[ks][1] = ld32(p1);
        qa[ks][2] = ld32(p0 + 8);
        qa[ks][3] = ld32(p1 + 8);
      }
    }
    const __nv_bfloat16* sk = skv + (j & 1) * 2 * TILE;
    const __nv_bfloat16* sv = sk + TILE;
    if (live) {
      // scores: sc[nt] holds rows (g, g+8) x keys (nt*8 + 2t, nt*8 + 2t + 1)
      float sc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
        if (k0 + nt * 8 < S) {  // key tiles wholly past S are skipped
          const __nv_bfloat16* kp = sk + (nt * 8 + g) * LD + t * 2;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            mma_16816(sc[nt], qa[ks], ld32(kp + ks * 16),
                      ld32(kp + ks * 16 + 8));
        }
      }
      float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + nt * 8 + t * 2 + e;
          float x0 = sc[nt][e] * scale, x1 = sc[nt][2 + e] * scale;
          if (br0) {
            if (col < S) {
              x0 += br0[col];
              x1 += br1[col];
            }
            x0 = fmaxf(x0, kNeg);
            x1 = fmaxf(x1, kNeg);
          }
          if (col >= S) x0 = x1 = -INFINITY;
          sc[nt][e] = x0;
          sc[nt][2 + e] = x1;
          mt0 = fmaxf(mt0, x0);
          mt1 = fmaxf(mt1, x1);
        }
      }
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
      const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
      const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        oacc[dt][0] *= a0;
        oacc[dt][1] *= a0;
        oacc[dt][2] *= a1;
        oacc[dt][3] *= a1;
      }
      // P in f32 for the sums, cast to bf16 as the A operand of P.V: score
      // tiles 2kk and 2kk+1 are exactly the A fragment of keys 16kk..16kk+15.
      uint32_t pa[NT / 2][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float p0 = expf(sc[nt][0] - m0), p1 = expf(sc[nt][1] - m0);
        const float p2 = expf(sc[nt][2] - m1), p3 = expf(sc[nt][3] - m1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
        pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      // V's B fragments by transposed ldmatrix: tiles (keys 0-7, dims dt),
      // (keys 8-15, dims dt), then the same for dims dt + 1.
      const int vkey = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int vdim = (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        if (k0 + kk * 16 < S) {
#pragma unroll
          for (int dt = 0; dt < DT; dt += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, sv + (kk * 16 + vkey) * LD + dt * 8 + vdim);
            mma_16816(oacc[dt], pa[kk], b[0], b[1]);
            mma_16816(oacc[dt + 1], pa[kk], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + t * 2;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(os + row0 * st.o[2] + col) =
          __floats2bfloat162_rn(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(os + row1 * st.o[2] + col) =
          __floats2bfloat162_rn(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
  }
}

template <int D>
constexpr size_t smem_bf16() {
  return (kBlockQ + 4 * kBlockK) * (D + 8) * sizeof(__nv_bfloat16);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const float* bias, void* o, int bh, int s, int heads,
                       const Strides& st, long long bias_bh_stride,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_f32<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + kBlockQ - 1) / kBlockQ);
  flash_fwd_f32<D><<<grid, kThreadsF32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(o), s, heads,
      st, bias_bh_stride, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const float* bias, void* o, int bh, int s, int heads,
                        const Strides& st, long long bias_bh_stride,
                        float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bf16<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + kBlockQ - 1) / kBlockQ);
  flash_fwd_bf16<D><<<grid, kThreadsBf16, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias,
      static_cast<__nv_bfloat16*>(o), s, heads, st, bias_bh_stride, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [batch, heads, s, d] given by element strides (12 values:
// batch, head and row strides of q, k, v, o in turn), the head dim
// contiguous; all f32 or all bf16 (is_bf16), every row 16-byte aligned.
// bias: null or contiguous f32 [1 or batch*heads, s, s] (bias_per_bh).
// Launches on `stream` without synchronising; returns the cudaError_t of
// the launch.
extern "C" int tlx_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* o, int batch, int heads, int s,
                                       int d, const long long* strides,
                                       int bias_per_bh, float scale,
                                       int is_bf16, void* stream) {
  const float* b = static_cast<const float*>(bias);
  const long long bs = bias_per_bh ? (long long)s * s : 0;
  const int bh = batch * heads;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define TLX_LAUNCH(kind, D) \
  return launch_##kind<D>(q, k, v, b, o, bh, s, heads, st, bs, scale, cs)
  if (is_bf16) {
    switch (d) {
      case 32: TLX_LAUNCH(bf16, 32);
      case 64: TLX_LAUNCH(bf16, 64);
      case 96: TLX_LAUNCH(bf16, 96);
      case 128: TLX_LAUNCH(bf16, 128);
    }
  } else {
    switch (d) {
      case 32: TLX_LAUNCH(f32, 32);
      case 64: TLX_LAUNCH(f32, 64);
      case 96: TLX_LAUNCH(f32, 96);
      case 128: TLX_LAUNCH(f32, 128);
    }
  }
#undef TLX_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tlx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
