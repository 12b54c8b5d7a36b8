// Shared device code of the fp32 one-shot prefill attention kernels
// (flash_attention.cu, block_sparse_attn.cu; bf16 runs on the tensor cores
// in attn_wgmma.cuh): one CTA owns a tile of 64 query rows of one (batch,
// query head) at head_dim 128, stages key/value sub-tiles of 64 keys in
// shared memory and runs the online softmax over them with fp32
// accumulation.
//
// Both kernels do 4 * 64 * 64 * 128 flops per staged sub-tile against
// 2 * 64 * 128 loaded elements: compute-bound.  fp32 inputs multiply on the
// fp32 CUDA cores (TF32 tensor cores would not keep the fp32 paths within
// 1e-4 of their plain versions) with a register-tiled
// outer product: the 256 threads form a 16 x 16 grid, thread (ty, tx) owns
// query rows ty*4..ty*4+3, score columns tx*4..tx*4+3 and output columns
// tx*4..tx*4+3 and 64+tx*4..64+tx*4+3.  Q and K are staged transposed
// (column-major) so each step of the score product is two 16-byte shared
// loads for 16 FMAs; P is staged transposed for the P.V product.  A row's
// softmax state (m, l) lives in the registers of the 16 threads that share
// the row, reduced with half-warp shuffles.  Masked probabilities are zero,
// and a row that saw no key finalizes 0 / 1e-20 = exact 0.
//
// Shared memory: Q^T, K^T, V (8192 floats each) + P^T (4096) = 112 KiB, so
// two CTAs fit on one SM.
#pragma once

#include <cuda_runtime.h>

namespace stem_attn {

constexpr int kD = 128;         // head_dim
constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // keys per staged sub-tile
constexpr int kThreads = 256;   // 16 x 16 thread grid
constexpr float kNegInf = -1e30f;

struct Smem {
  float qt[kD * kBQ];           // Q^T, pre-scaled: qt[c * kBQ + row]
  float kt[kD * kBK];           // K^T: kt[c * kBK + key]
  float v[kBK * kD];            // V:   v[key * kD + c]
  float pt[kBK * kBQ];          // P^T: pt[key * kBQ + row]
};

struct RowState {
  float o[4][8];                // rows ty*4+i; columns tx*4+{0..3}, 64+tx*4+{0..3}
  float m[4];
  float l[4];
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// 64 rows of `src` (row stride kD) into dst[c * 64 + row] times `mul`; rows
// >= valid are zero.  The row index runs fastest across threads so the
// transposed shared-memory writes fall on consecutive banks.
template <typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src, int valid,
                                                float mul) {
  for (int i = threadIdx.x; i < 64 * (kD / 4); i += kThreads) {
    const int r = i & 63, c4 = i >> 6;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = load4(src + (long long)r * kD + c4 * 4);
    float* d = dst + c4 * 4 * 64 + r;
    d[0] = x.x * mul;
    d[64] = x.y * mul;
    d[128] = x.z * mul;
    d[192] = x.w * mul;
  }
}

// 64 rows of `src` into dst[row * kD + c]; rows >= valid are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int valid) {
  for (int i = threadIdx.x; i < 64 * (kD / 4); i += kThreads) {
    const int r = i >> 5, c4 = i & 31;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = load4(src + (long long)r * kD + c4 * 4);
    store4(dst + r * kD + c4 * 4, x);
  }
}

__device__ __forceinline__ void init_state(RowState& st) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) st.o[i][c] = 0.f;
  }
}

// One staged sub-tile: keys kpos0..kpos0+63 against query rows
// qpos0..qpos0+63, causal (key position <= query position).  Expects
// sm.qt / sm.kt / sm.v filled and a __syncthreads() after the fill; ends
// with a __syncthreads() so the caller may refill the key/value buffers.
__device__ __forceinline__ void tile_step(Smem& sm, RowState& st, int qpos0, int kpos0) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < kD; ++c) {
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
      keep[j] = kpos0 + tx * 4 + j <= qp;
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
    for (int c = 0; c < 8; ++c) st.o[i][c] *= corr;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    store4(sm.pt + (tx * 4 + j) * kBQ + ty * 4,
           make_float4(p[0][j], p[1][j], p[2][j], p[3][j]));
  __syncthreads();

#pragma unroll 4
  for (int j = 0; j < kBK; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(sm.pt + j * kBQ + ty * 4);
    const float4 v0 = *reinterpret_cast<const float4*>(sm.v + j * kD + tx * 4);
    const float4 v1 = *reinterpret_cast<const float4*>(sm.v + j * kD + 64 + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) st.o[i][c] = fmaf(av[i], vv[c], st.o[i][c]);
  }
  __syncthreads();
}

// Stage one 64-key sub-tile (rows >= valid zeroed) and run tile_step.
template <typename T>
__device__ __forceinline__ void stage_and_step(Smem& sm, RowState& st, const T* kbase,
                                               const T* vbase, int valid, int qpos0,
                                               int kpos0) {
  load_transposed(sm.kt, kbase, valid, 1.f);
  load_rows(sm.v, vbase, valid);
  __syncthreads();
  tile_step(sm, st, qpos0, kpos0);
}

// out rows qpos0 + ty*4 + i that are < valid_rows: acc / max(l, 1e-20).
template <typename T>
__device__ __forceinline__ void store_rows(const RowState& st, T* out, int valid_rows) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= valid_rows) continue;
    const float l = fmaxf(st.l[i], 1e-20f);
    T* dst = out + (long long)r * kD;
    store4(dst + tx * 4, make_float4(st.o[i][0] / l, st.o[i][1] / l,
                                     st.o[i][2] / l, st.o[i][3] / l));
    store4(dst + 64 + tx * 4, make_float4(st.o[i][4] / l, st.o[i][5] / l,
                                          st.o[i][6] / l, st.o[i][7] / l));
  }
}

template <typename Kernel>
inline cudaError_t prepare(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace stem_attn
