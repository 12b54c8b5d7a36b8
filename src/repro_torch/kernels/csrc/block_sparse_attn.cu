// Stem block-sparse causal attention for Hopper (sm_90a): the executor of
// every one-shot Stem prefill layer.
//
// stem_block_sparse_attention replaces _sparse_kernel
// (src/repro/kernels/block_sparse_attn.py:52).
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library with
// a plain C interface (no PyTorch headers), loaded with ctypes.  The entry
// point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() of its launch; the Python wrapper in
// repro_torch/kernels/block_sparse_attn.py checks device, dtype, shape,
// contiguity and alignment and holds the plain PyTorch version this kernel
// is tested against.
//
// Bound on the H100: 4 * d flops per (query, key) pair of the selected
// blocks (causal inside the diagonal block) against one read of q, of each
// selected K/V block, and of the selection: compute-bound at Stem's budgets.
// The TPU kernel's scalar-prefetched index map and sequential slot axis
// become a loop inside the CTA: each CTA reads its row's live count and
// selected block ids and attends each selected block once.  The loop ends
// at the row's own live count, so dead slots cost nothing and need no
// revisit filling; ids outside [0, nq) are skipped; a row with cnt == 0
// writes exact zeros (0 / max(l, 1e-20)).  Key tiles above the diagonal are
// never loaded; the diagonal one (block id == the row's own block, wherever
// it sits in the list) is masked exactly.  With group_dedup the selection
// has one row per KV head: the g query heads of a KV head read the same
// index row (the reference's fused (g * B, d) query tile, whose row r is
// query position i*B + r mod B); without it the KV head is head / group.
//
// bf16 (the serving dtype) at head_dim 128 and a block that is a multiple
// of 128 runs on the tensor cores (attn_wgmma.cuh): one CTA per 128 query
// rows (a query block at bs = 128), the selected blocks streamed as 128-key
// tiles through a TMA ring into wgmma products.  The grid puts the query
// heads fastest, so the g heads of a KV head run side by side and the
// second read of each selected K/V block comes from L2, and walks the query
// blocks from the last (the most selected blocks, min(k_max, i + 1)) to the
// first.  fp32 at every (q/k, v) head_dim pair of head_dims.cuh and every
// block, and bf16 off that shape (MLA's q/k 192 with v 128 among them), run the
// CUDA-core tile of attn_tile.cuh (64-key sub-tiles, fp32 products and
// probabilities: within 1e-4 of the plain version in fp32): a CTA owns 64
// query rows of a block, or the whole block where it is under 64 rows (the
// engine's small configurations run block 8), and a block that is no
// multiple of 64 stages its last sub-tile short, the missing keys masked.
#include "attn_tile.cuh"
#include "attn_wgmma.cuh"
#include "head_dims.cuh"

namespace {

using namespace stem_attn;

// grid (nq * ceil(bs / 64), hq, b): CTA x owns rows [sub * 64, sub * 64 +
// 64) of query block x / tiles.  KMASK: bs is no multiple of 64, so a
// CTA's rows and a block's last key sub-tile may be short.
template <typename T, int D, int DV, bool KMASK>
__global__ void __launch_bounds__(kThreads, tile_min_ctas<D, DV>())
block_sparse_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ idx,
                    const int* __restrict__ cnt, T* __restrict__ out, int hq, int hk,
                    int dedup, int n, int bs, int kmax, float scale) {
  extern __shared__ float4 smem_raw[];
  Smem<D, DV>& sm = *reinterpret_cast<Smem<D, DV>*>(smem_raw);
  const int tiles = KMASK ? (bs + kBQ - 1) / kBQ : bs / kBQ;
  const int i = blockIdx.x / tiles, sub = blockIdx.x - i * tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const int hsel = dedup ? hk : hq;
  const int nq = n / bs;
  const long long row = ((long long)b * hsel + (dedup ? kvh : h)) * nq + i;
  const int q0 = i * bs + sub * kBQ;
  const int qrows = KMASK ? min(kBQ, bs - sub * kBQ) : kBQ;
  const long long qrow0 = ((long long)b * hq + h) * n + q0;
  const long long krow0 = ((long long)b * hk + kvh) * n;

  load_transposed<D>(sm.qt, q + qrow0 * D, qrows, scale);
  RowState<DV> st;
  init_state(st);
  const int live = min(cnt[row], kmax);
  for (int s = 0; s < live; ++s) {
    const int j = idx[row * kmax + s];
    if (j < 0 || j >= nq) continue;               // an out-of-range id is not read
    for (int t = 0; t < bs; t += kBK) {
      const int k0 = j * bs + t;
      if (k0 > q0 + qrows - 1) break;             // the rest is above the diagonal
      stage_and_step<D, DV, KMASK>(sm, st, k + (krow0 + k0) * D, v + (krow0 + k0) * DV,
                                   KMASK ? min(kBK, bs - t) : kBK, q0, k0);
    }
  }
  store_rows<DV>(st, out + qrow0 * DV, qrows);
}

template <typename T, int D, int DV, bool KMASK>
int launch(const void* q, const void* k, const void* v, const int* idx,
           const int* cnt, void* out, int b, int hq, int hk, int dedup, int n, int bs,
           int kmax, float scale, cudaStream_t stream) {
  cudaError_t err = prepare<D, DV>(block_sparse_kernel<T, D, DV, KMASK>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n / bs * ((bs + kBQ - 1) / kBQ), hq, b);
  block_sparse_kernel<T, D, DV, KMASK><<<grid, kThreads, sizeof(Smem<D, DV>), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, idx, cnt, (T*)out, hq, hk, dedup, n, bs,
      kmax, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, int DV>
int launch_d(const void* q, const void* k, const void* v, const int* idx,
             const int* cnt, void* out, int b, int hq, int hk, int dedup, int n, int bs,
             int kmax, float scale, cudaStream_t stream) {
  if (bs % kBQ == 0)
    return launch<T, D, DV, false>(q, k, v, idx, cnt, out, b, hq, hk, dedup, n, bs, kmax,
                                   scale, stream);
  return launch<T, D, DV, true>(q, k, v, idx, cnt, out, b, hq, hk, dedup, n, bs, kmax,
                                scale, stream);
}

template <typename T>
int launch_tile(const void* q, const void* k, const void* v, const int* idx,
                const int* cnt, void* out, int b, int hq, int hk, int dedup, int n, int d,
                int dv, int bs, int kmax, float scale, cudaStream_t stream) {
  STEM_HEAD_DIM_PAIR_SWITCH(d, dv, launch_d<T, D, DV>(q, k, v, idx, cnt, out, b, hq, hk,
                                                      dedup, n, bs, kmax, scale, stream))
}

// bf16 on the tensor cores: the 128-key tiles of the row's live selected
// blocks that hold a key at or below the tile's first query row q0; only
// the diagonal one (off 0) is masked.
struct SparseTiles {
  const int* ids;
  int live, nq, bs, q0, s, k;     // k: next key offset inside block ids[s]
  __device__ __forceinline__ bool next(int& k0, int& off) {
    while (s < live) {
      const int j = ids[s];
      if (j >= 0 && j < nq && k < bs && j * bs + k <= q0) {
        k0 = j * bs + k;
        off = k0 - q0;
        k += stem_wg::kBN;
        return true;
      }
      ++s;
      k = 0;
    }
    return false;
  }
};

__global__ void __launch_bounds__(stem_wg::kThreads, 1)
block_sparse_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const int* __restrict__ idx, const int* __restrict__ cnt,
                          __nv_bfloat16* __restrict__ out, int hq, int hk, int dedup, int n,
                          int bs, int kmax, float scale) {
  extern __shared__ uint8_t smem_wg[];
  const int tiles = bs / stem_wg::kBM;
  const int x = gridDim.y - 1 - blockIdx.y;          // heaviest query blocks first
  const int i = x / tiles, sub = x - i * tiles;
  const int h = blockIdx.x, b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const int hsel = dedup ? hk : hq;
  const int nq = n / bs;
  const long long row = ((long long)b * hsel + (dedup ? kvh : h)) * nq + i;
  const int q0 = i * bs + sub * stem_wg::kBM;
  const long long q_row = ((long long)b * hq + h) * n + q0;
  const long long kv_row = ((long long)b * hk + kvh) * n;
  const SparseTiles sel{idx + row * kmax, min(cnt[row], kmax), nq, bs, q0, 0, 0};
  stem_wg::attend_tile(smem_wg, &tq, &tk, &tv, q_row, kv_row, sel, out + q_row * stem_wg::kD,
                       stem_wg::kBM, scale);
}

int launch_wgmma(const void* q, const void* k, const void* v, const int* idx, const int* cnt,
                 void* out, int b, int hq, int hk, int dedup, int n, int bs, int kmax,
                 float scale, cudaStream_t stream) {
  if (bs % stem_wg::kBM != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!stem_wg::make_maps(&tq, &tk, &tv, q, k, v, b, hq, hk, n))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = stem_wg::prepare(block_sparse_wgmma_kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq, n / stem_wg::kBM, b);
  block_sparse_wgmma_kernel<<<grid, stem_wg::kThreads, stem_wg::kSmemBytes, stream>>>(
      tq, tk, tv, idx, cnt, (__nv_bfloat16*)out, hq, hk, dedup, n, bs, kmax, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (b, hq, n, d), k (b, hk, n, d), v (b, hk, n, dv), out (b, hq, n, dv);
// idx (b, h_sel, n/bs, kmax) and cnt (b, h_sel, n/bs) int32 with h_sel =
// hk when dedup else hq; all contiguous.  (d, dv) a pair of head_dims.cuh
// and bs dividing n (the wrapper checks).  is_bf16: 0 = float32 (the
// CUDA-core tile), 1 = bfloat16 for q/k/v/out: the tensor-core tile at d =
// dv = 128 and bs a multiple of 128 (q, k, v 16-byte aligned for TMA),
// else the CUDA-core tile.
int stem_block_sparse_attention(const void* q, const void* k, const void* v,
                                const int* idx, const int* cnt, void* out, int b,
                                int hq, int hk, int dedup, int n, int d, int dv, int bs,
                                int kmax, int is_bf16, float scale, void* stream) {
  if (hk <= 0 || hq % hk != 0 || bs <= 0 || n % bs != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16 && d == stem_wg::kD && dv == stem_wg::kD && bs % stem_wg::kBM == 0)
    return launch_wgmma(q, k, v, idx, cnt, out, b, hq, hk, dedup, n, bs, kmax, scale, st);
  if (is_bf16)
    return launch_tile<__nv_bfloat16>(q, k, v, idx, cnt, out, b, hq, hk, dedup, n, d, dv,
                                      bs, kmax, scale, st);
  return launch_tile<float>(q, k, v, idx, cnt, out, b, hq, hk, dedup, n, d, dv, bs, kmax,
                            scale, st);
}

}  // extern "C"
