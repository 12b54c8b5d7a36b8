// Shared device code of the one-shot prefill attention kernels on the CUDA
// cores (flash_attention.cu, block_sparse_attn.cu): fp32 at every head_dim,
// and bf16 off the tensor-core tile's shape (head_dims other than q/k = v =
// 128, or a block-sparse block that is no multiple of 128; bf16 at 128 runs
// attn_wgmma.cuh).  One CTA owns a tile of 64 query rows of one (batch,
// query head), stages key/value sub-tiles of 64 keys in shared memory and
// runs the online softmax over them with fp32 accumulation; bf16 inputs are
// widened to fp32 as they are staged and the output is rounded once.
//
// Both kernels do 2 * 64 * 64 * (D + DV) flops per staged sub-tile against
// 64 * (D + DV) loaded elements: compute-bound.  The products run on the
// fp32 CUDA cores (TF32 tensor cores would not keep the fp32 paths within
// 1e-4 of their plain versions) with a register-tiled outer product: the
// 256 threads form a 16 x 16 grid, thread (ty, tx) owns query rows
// ty*4..ty*4+3, score columns tx*4..tx*4+3 and, in each 64-column group g
// of the value head_dim, output columns 64g+tx*4..64g+tx*4+3.  Q and K are
// staged transposed (column-major) so each step of the score product is two
// 16-byte shared loads for 16 FMAs; P is staged transposed for the P.V
// product.  A row's softmax state (m, l) lives in the registers of the 16
// threads that share the row, reduced with half-warp shuffles.  Masked
// probabilities are zero, and a row that saw no key finalizes 0 / 1e-20 =
// exact 0.
//
// The q/k head_dim D and the v head_dim DV are template arguments (8 ..
// 256; MLA runs D = 192 with DV = 128): the score product and Q^T / K^T go
// by D, the V tile, the output columns and the store by DV.  A head_dim
// under 64 is zero-filled to 64 columns in shared memory (the score product
// stops at D; the zero columns of V give zero outputs that are not stored).
// A sub-tile whose keys are fewer than 64 (a block-sparse block that is no
// multiple of 64) masks the missing keys (KMASK).
//
// Shared memory: Q^T, K^T (64 * max(D, 64) floats each), V (64 * max(DV,
// 64)) + P^T (4096): 64 KiB at D, DV <= 64, 112 KiB at 128 (two CTAs an
// SM), 144 KiB at (192, 128), 160 KiB at 192 and 208 KiB at 256 (one).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stem_attn {

constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // keys per staged sub-tile
constexpr int kThreads = 256;   // 16 x 16 thread grid
constexpr float kNegInf = -1e30f;

// Columns of the staged tile: the head_dim, at least 64.
template <int D>
__host__ __device__ constexpr int tile_cols() { return D < 64 ? 64 : D; }

template <int D, int DV>
struct Smem {
  static constexpr int DP = tile_cols<D>();
  static constexpr int DVP = tile_cols<DV>();
  float qt[DP * kBQ];           // Q^T, pre-scaled: qt[c * kBQ + row]
  float kt[DP * kBK];           // K^T: kt[c * kBK + key]
  float v[kBK * DVP];           // V:   v[key * DVP + c]
  float pt[kBK * kBQ];          // P^T: pt[key * kBQ + row]
};

// CTAs of a tile kernel an SM holds (its __launch_bounds__ minimum): two
// where two tiles and their 1 KiB reserves fit the SM's 228 KiB.
template <int D, int DV>
__host__ __device__ constexpr int tile_min_ctas() {
  return 2 * (sizeof(Smem<D, DV>) + 1024) <= 228 * 1024 ? 2 : 1;
}

// DV: the value head_dim (the output columns).
template <int DV>
struct RowState {
  static constexpr int OC = tile_cols<DV>() / 16;  // output columns a thread
  float o[4][OC];               // rows ty*4+i; column 64g+tx*4+e at o[i][4g+e]
  float m[4];
  float l[4];
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four bf16 values (8 bytes, 8-byte aligned) widened to fp32.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(x.x, x.y);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = u;
}

// 64 rows of `src` (row stride D) into dst[c * 64 + row] times `mul`; rows
// >= valid and columns >= D are zero.  The row index runs fastest across
// threads so the transposed shared-memory writes fall on consecutive banks.
template <int D, typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src, int valid,
                                                float mul) {
  constexpr int DP = tile_cols<D>();
  for (int i = threadIdx.x; i < 64 * (DP / 4); i += kThreads) {
    const int r = i & 63, c4 = i >> 6;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid && (D == DP || c4 * 4 < D)) x = load4(src + (long long)r * D + c4 * 4);
    float* d = dst + c4 * 4 * 64 + r;
    d[0] = x.x * mul;
    d[64] = x.y * mul;
    d[128] = x.z * mul;
    d[192] = x.w * mul;
  }
}

// 64 rows of `src` into dst[row * DP + c]; rows >= valid and columns >= D
// are zero.
template <int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int valid) {
  constexpr int DP = tile_cols<D>();
  for (int i = threadIdx.x; i < 64 * (DP / 4); i += kThreads) {
    const int r = i / (DP / 4), c4 = i % (DP / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid && (D == DP || c4 * 4 < D)) x = load4(src + (long long)r * D + c4 * 4);
    store4(dst + r * DP + c4 * 4, x);
  }
}

template <int DV>
__device__ __forceinline__ void init_state(RowState<DV>& st) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RowState<DV>::OC; ++c) st.o[i][c] = 0.f;
  }
}

// One staged sub-tile: keys kpos0..kpos0+63 against query rows
// qpos0..qpos0+63, causal (key position <= query position); with KMASK
// also only the sub-tile's first kvalid keys.  Expects sm.qt / sm.kt /
// sm.v filled and a __syncthreads() after the fill; ends with a
// __syncthreads() so the caller may refill the key/value buffers.
template <int D, int DV, bool KMASK>
__device__ __forceinline__ void tile_step(Smem<D, DV>& sm, RowState<DV>& st, int qpos0,
                                          int kpos0, int kvalid) {
  constexpr int DVP = tile_cols<DV>();
  constexpr int OC = RowState<DV>::OC;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {                  // zero-filled columns add nothing
    const float4 a = *reinterpret_cast<const float4*>(sm.qt + c * kBQ + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(sm.kt + c * kBK + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }

  float p[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = qpos0 + ty * 4 + i;
    bool keep[4];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      keep[j] = kpos0 + tx * 4 + j <= qp && (!KMASK || tx * 4 + j < kvalid);
      if (keep[j]) mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(st.m[i], mx);
    const float corr = expf(st.m[i] - m_new);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[i][j] = keep[j] ? expf(s[i][j] - m_new) : 0.f;
      ps += p[i][j];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
    st.l[i] = st.l[i] * corr + ps;
    st.m[i] = m_new;
#pragma unroll
    for (int c = 0; c < OC; ++c) st.o[i][c] *= corr;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    store4(sm.pt + (tx * 4 + j) * kBQ + ty * 4,
           make_float4(p[0][j], p[1][j], p[2][j], p[3][j]));
  __syncthreads();

#pragma unroll 4
  for (int j = 0; j < kBK; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(sm.pt + j * kBQ + ty * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float vv[OC];
#pragma unroll
    for (int g = 0; g < OC / 4; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(sm.v + j * DVP + 64 * g + tx * 4);
      vv[4 * g] = x.x;
      vv[4 * g + 1] = x.y;
      vv[4 * g + 2] = x.z;
      vv[4 * g + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < OC; ++c) st.o[i][c] = fmaf(av[i], vv[c], st.o[i][c]);
  }
  __syncthreads();
}

// Stage one 64-key sub-tile (rows >= valid zeroed; K rows of D, V rows of
// DV) and run tile_step.
template <int D, int DV, bool KMASK, typename T>
__device__ __forceinline__ void stage_and_step(Smem<D, DV>& sm, RowState<DV>& st,
                                               const T* kbase, const T* vbase, int valid,
                                               int qpos0, int kpos0) {
  load_transposed<D>(sm.kt, kbase, valid, 1.f);
  load_rows<DV>(sm.v, vbase, valid);
  __syncthreads();
  tile_step<D, DV, KMASK>(sm, st, qpos0, kpos0, valid);
}

// out rows ty*4 + i that are < valid_rows (row stride DV), columns < DV:
// acc / max(l, 1e-20) in T.  lse (optional, at the tile's first row): each
// row's log-sum-exp m + ln l, +inf for a row that saw no key (l = 0).
template <int DV, typename T>
__device__ __forceinline__ void store_rows(const RowState<DV>& st, T* out, int valid_rows,
                                           float* lse) {
  constexpr int OC = RowState<DV>::OC;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= valid_rows) continue;
    if (lse != nullptr && tx == 0) lse[r] = st.l[i] > 0.f ? st.m[i] + logf(st.l[i]) : INFINITY;
    const float l = fmaxf(st.l[i], 1e-20f);
    T* dst = out + (long long)r * DV;
#pragma unroll
    for (int g = 0; g < OC / 4; ++g) {
      const int col = 64 * g + tx * 4;
      if (DV >= 64 || col < DV)
        store4(dst + col, make_float4(st.o[i][4 * g] / l, st.o[i][4 * g + 1] / l,
                                      st.o[i][4 * g + 2] / l, st.o[i][4 * g + 3] / l));
    }
  }
}

template <int D, int DV, typename Kernel>
inline cudaError_t prepare(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem<D, DV>));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace stem_attn
