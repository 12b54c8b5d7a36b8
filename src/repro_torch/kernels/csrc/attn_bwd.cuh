// Shared device code of the attention backward kernels on the fp32 CUDA
// cores (flash_attention.cu, block_sparse_attn.cu): the route the wrappers'
// backward_route names "cuda_core", taken by fp32 at every (q/k, v)
// head_dim pair of head_dims.cuh and by bf16 off the tensor-core route's
// shape (head_dims other than q/k = v = 128, MLA's (192, 128) among them,
// and block-sparse blocks that are no multiple of 128); bf16 is loaded and
// stored around the same fp32 math.  bf16 at (128, 128) runs
// attn_bwd_wgmma.cuh.
//
// With S = scale * Q.K^T, P = exp(S - lse), O = P.V and dO the output's
// gradient:
//   delta = rowsum(dO * O),  dP = dO.V^T,  dS = P * (dP - delta),
//   dQ = scale * dS.K,  dK = scale * dS^T.Q,  dV = P^T.dO.
// lse, each row's log-sum-exp over its keys (+inf for a row that saw no
// key: P = 0), is the forward's: both forward routes save it.  Two kernels
// per backward, no atomics (a fixed summation order, bitwise run to run):
//   dq_tile   one CTA per 64 query rows: delta from O and dO, then one pass
//             over the row's key tiles for dS and dQ; writes delta to
//             global scratch for the second kernel.
//   dkdv_step one CTA per 64 keys of one KV head accumulates dK and dV over
//             every (query head of the GQA group, query tile) that sees the
//             keys, in a fixed order, and stores them once.
// Bound: 2 * (3 d + 2 dv) flops a causal pair (S, dP, dV, dK, dQ) against
// one read of q, k, v, o, dO and lse: compute-bound.  The split without
// atomics recomputes S and dP in the dk / dv kernel: 7 products a pair.
// Every operand moves as 64 x 64 fp32 chunks (a 64-column slice of the
// head_dim) through shared memory: the products are the forward tile's
// register-tiled outer products (attn_tile.cuh), a 16 x 16 thread grid
// with a 4 x 4 block a thread, so shared memory (80 KiB) does not grow with
// the head_dim; the price is that Q, dO, K and V are staged again for each
// product, from L2.  P and dS stay fp32.  Accumulators (dQ, or dK and dV)
// live in registers: head_dim / 4 floats a thread each.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace stem_bwd {

using stem_attn::load4;
using stem_attn::store4;

constexpr int kT = 64;          // query rows / keys of a tile, columns of a chunk
constexpr int kThreads = 256;   // 16 x 16 thread grid
constexpr float kNegInf = -1e30f;

template <int D>
__host__ __device__ constexpr int chunks() { return (D + kT - 1) / kT; }

struct Smem {
  float a[kT * kT];     // transposed operand of the score products
  float b[kT * kT];     // the other transposed operand
  float p[kT * kT];     // P (or dS) laid out [summed index][output row]
  float ds[kT * kT];    // dS, laid out as p
  float c[kT * kT];     // a row-major chunk of the output products
};

// dst[c * 64 + r] = src[r * ld + c0 + c] * mul for r < rows, c0 + c < D;
// 0 elsewhere.  D and c0 are multiples of 4.
template <typename T>
__device__ __forceinline__ void stage_t(float* dst, const T* src, int ld, int c0, int D,
                                        int rows, float mul) {
  for (int i = threadIdx.x; i < kT * (kT / 4); i += kThreads) {
    const int r = i & (kT - 1), c4 = i >> 6;
    const int c = c0 + c4 * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && c < D) x = load4(src + (long long)r * ld + c);
    float* d = dst + c4 * 4 * kT + r;
    d[0] = x.x * mul;
    d[kT] = x.y * mul;
    d[2 * kT] = x.z * mul;
    d[3 * kT] = x.w * mul;
  }
}

// dst[r * 64 + c] = src[r * ld + c0 + c] for r < rows, c0 + c < D; 0 elsewhere.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int ld, int c0, int D,
                                           int rows) {
  for (int i = threadIdx.x; i < kT * (kT / 4); i += kThreads) {
    const int r = i >> 4, c4 = i & 15;
    const int c = c0 + c4 * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && c < D) x = load4(src + (long long)r * ld + c);
    store4(dst + r * kT + c4 * 4, x);
  }
}

// s[i][j] += sum_{c < kc} at[c][ty*4 + i] * bt[c][tx*4 + j].
__device__ __forceinline__ void mm_tt(float (&s)[4][4], const float* at, const float* bt,
                                      int kc) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 8
  for (int c = 0; c < kc; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(at + c * kT + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(bt + c * kT + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][e] += sum_{j < 64} pt[j][ty*4 + i] * rows[j][tx*4 + e].
__device__ __forceinline__ void mm_pv(float (&acc)[4][4], const float* pt, const float* rows) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 8
  for (int j = 0; j < kT; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(pt + j * kT + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(rows + j * kT + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(av[i], bv[e], acc[i][e]);
  }
}

// s = (mul_a * A).B^T over the head_dim D for the 64-row tiles A (rows_a
// valid, row stride D) and B (rows_b valid): s[i][j] pairs A's row ty*4+i
// with B's row tx*4+j.  Starts and ends with the shared buffers free.
template <int D, typename T>
__device__ __forceinline__ void scores(Smem& sm, float (&s)[4][4], const T* a, int rows_a,
                                       float mul_a, const T* b, int rows_b) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int g = 0; g < chunks<D>(); ++g) {
    stage_t(sm.a, a, D, kT * g, D, rows_a, mul_a);
    stage_t(sm.b, b, D, kT * g, D, rows_b, 1.f);
    __syncthreads();
    mm_tt(s, sm.a, sm.b, min(kT, D - kT * g));
    __syncthreads();
  }
}

// out[i][j] -> pt[(tx*4 + j) * 64 + ty*4 + i]: the layout mm_pv sums over j.
__device__ __forceinline__ void store_t(float* pt, const float (&x)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kT + ty * 4) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
}

// acc rows ty*4 + i (< rows), columns 64g + tx*4 + e (< D), times mul, into
// dst (row stride D).
template <int D, typename T>
__device__ __forceinline__ void store_acc(T* dst, const float (&acc)[chunks<D>()][4][4],
                                          int rows, float mul) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int g = 0; g < chunks<D>(); ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, c = kT * g + tx * 4;
      if (r < rows && c < D)
        store4(dst + (long long)r * D + c,
               make_float4(acc[g][i][0] * mul, acc[g][i][1] * mul, acc[g][i][2] * mul,
                           acc[g][i][3] * mul));
    }
}

// dQ of one tile of `qrows` query rows starting at position q0.  q, o, dout,
// dq, lse, delta point at the tile's first row (row strides D, DV, DV, D,
// 1, 1); k, v at the KV head's first key.  lse is the forward's (+inf for
// a row that saw no key: P = 0); delta is written for the dk / dv kernel.
// Tiles::next(k0, krows) walks the key tiles the rows see (each of <= 64
// keys, all at positions <= the last row's).
template <typename T, int D, int DV, typename Tiles>
__device__ __forceinline__ void dq_tile(Smem& sm, const T* q, const T* o, const T* dout,
                                        const T* k, const T* v, T* dq, const float* lse_in,
                                        float* delta_out, int q0, int qrows, Tiles tiles,
                                        float scale) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float delta[4], lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    float acc = 0.f;
    if (r < qrows)
      for (int c = tx * 4; c < DV; c += kT) {
        const float4 a = load4(o + (long long)r * DV + c);
        const float4 b = load4(dout + (long long)r * DV + c);
        acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    delta[i] = acc;
    lse[i] = r < qrows ? lse_in[r] : INFINITY;
    if (tx == 0 && r < qrows) delta_out[r] = acc;
  }

  // dS and dQ.
  int k0, krows;
  float acc[chunks<D>()][4][4];
#pragma unroll
  for (int g = 0; g < chunks<D>(); ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][i][e] = 0.f;
  while (tiles.next(k0, krows)) {
    const T* kt = k + (long long)k0 * D;
    float s[4][4], dp[4][4];
    scores<D>(sm, s, q, qrows, scale, kt, krows);
    scores<DV>(sm, dp, dout, qrows, 1.f, v + (long long)k0 * DV, krows);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool keep = tx * 4 + j < krows && k0 + tx * 4 + j <= qp;
        s[i][j] = keep ? expf(s[i][j] - lse[i]) * (dp[i][j] - delta[i]) : 0.f;
      }
    }
    store_t(sm.p, s);   // dS: p[key][query row]
    __syncthreads();
#pragma unroll
    for (int g = 0; g < chunks<D>(); ++g) {
      stage_rows(sm.c, kt, D, kT * g, D, krows);
      __syncthreads();
      mm_pv(acc[g], sm.p, sm.c);
      __syncthreads();
    }
  }
  store_acc<D>(dq, acc, qrows, scale);
}

template <int D, int DV>
struct KVAcc {
  float dk[chunks<D>()][4][4];
  float dv[chunks<DV>()][4][4];
};

template <int D, int DV>
__device__ __forceinline__ void init_acc(KVAcc<D, DV>& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int g = 0; g < chunks<D>(); ++g) acc.dk[g][i][e] = 0.f;
#pragma unroll
      for (int g = 0; g < chunks<DV>(); ++g) acc.dv[g][i][e] = 0.f;
    }
}

// One query tile (qrows rows at position q0; q, dout, lse, delta at its
// first row) against the CTA's key tile (krows keys at position k0; k, v at
// its first key): dV += P^T.dO, dK += dS^T.Q (unscaled: the caller scales
// dK once).
template <typename T, int D, int DV>
__device__ __forceinline__ void dkdv_step(Smem& sm, KVAcc<D, DV>& acc, const T* k,
                                          const T* v, int k0, int krows, const T* q,
                                          const T* dout, const float* lse,
                                          const float* delta, int q0, int qrows,
                                          float scale) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
  // s[i][j]: key ty*4 + i against query tx*4 + j.
  scores<D>(sm, s, k, krows, scale, q, qrows);
  scores<DV>(sm, dp, v, krows, 1.f, dout, qrows);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = tx * 4 + j;
    const bool valid = r < qrows;
    const float L = valid ? lse[r] : 0.f;
    const float Dl = valid ? delta[r] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool keep = valid && ty * 4 + i < krows && k0 + ty * 4 + i <= q0 + r;
      const float p = keep ? expf(s[i][j] - L) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - Dl);
    }
  }
  store_t(sm.p, s);     // P:  p[query][key]
  store_t(sm.ds, dp);   // dS: ds[query][key]
  __syncthreads();
#pragma unroll
  for (int g = 0; g < chunks<DV>(); ++g) {
    stage_rows(sm.c, dout, DV, kT * g, DV, qrows);
    __syncthreads();
    mm_pv(acc.dv[g], sm.p, sm.c);
    __syncthreads();
  }
#pragma unroll
  for (int g = 0; g < chunks<D>(); ++g) {
    stage_rows(sm.c, q, D, kT * g, D, qrows);
    __syncthreads();
    mm_pv(acc.dk[g], sm.ds, sm.c);
    __syncthreads();
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

}  // namespace stem_bwd
