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
// bf16 (the serving dtype) at the pairs of head_dims.cuh
// STEM_WGMMA_PAIR_SWITCH ((64, 64), (128, 128), MLA's (192, 128) and (192,
// 192), (256, 256)) and a block that is a multiple of 128 runs on the
// tensor cores (attn_wgmma.cuh, one instance per pair at its TileOf shape):
// one CTA per 128 query rows (a query block at bs = 128), the selected
// blocks streamed as 128- or 64-key tiles through a TMA ring into wgmma
// products.  The grid walks the query blocks from the last (the most
// selected blocks, min(k_max, i + 1)) to the first, with the query heads
// fastest (the g heads of a KV head side by side, the second read of each
// selected K/V block from L2) while the K / V of all heads fit twice in
// L2, else the query blocks of one head fastest (stem_wg::tiles_fastest).
// fp32 at every (q/k, v) head_dim pair of head_dims.cuh and every block,
// and bf16 off those shapes (the narrow pairs, blocks off 128), run the
// CUDA-core tile of attn_tile.cuh (64-key sub-tiles, fp32 products and
// probabilities: within 1e-4 of the plain version in fp32): a CTA owns 64
// query rows of a block, or the whole block where it is under 64 rows (the
// engine's small configurations run block 8), and a block that is no
// multiple of 64 stages its last sub-tile short, the missing keys masked.
//
// Both routes save each row's natural-log log-sum-exp (+inf for a row that
// saw no key) when the caller passes an lse buffer (the training path's
// autograd Function); serving passes none.
//
// stem_block_sparse_attention_bwd is the gradient of the same function (the
// TPU kernel has none: the reference trains through XLA's autodiff of its
// gather executor), two kernels that read the forward's lse and sum
// without atomics.  The dq kernel walks the row's live selected blocks as
// the forward does; the dk / dv kernel the transposed selection (tidx,
// tcnt: for each (batch, selection row, key block) the query blocks whose
// live prefix holds it, in increasing order, built by the wrapper), for
// each query head of the group that reads that selection row, so a key
// block's gradient is summed in one CTA in a fixed order.  The wrapper's
// backward_route picks the route, the forward's table: bf16 at the pairs of
// STEM_WGMMA_PAIR_SWITCH and a block that is a multiple of 128 runs
// attn_bwd_wgmma.cuh on the tensor cores, one instance per pair at its
// stem_bwg::BwdOf shape (block_sparse_bwd_dq_wgmma_kernel per 128 query
// rows, block_sparse_bwd_dkdv_wgmma_kernel per 128 keys (64 at d + dv >
// 256) over 64-query tiles; P and dS rounded to bf16); every other dtype,
// pair and block runs
// attn_bwd.cuh's fp32 CUDA-core tiles, fed the lse of either forward route
// (block_sparse_bwd_dq_kernel per 64 query rows of a block, or the block
// under 64 rows; block_sparse_bwd_dkdv_kernel per 64 keys).  Bound: 2 * (3
// d + 2 dv) flops a causal pair of the selected blocks; 7 products a pair
// done.
#include "attn_bwd.cuh"
#include "attn_bwd_wgmma.cuh"
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
                    const int* __restrict__ cnt, T* __restrict__ out,
                    float* __restrict__ lse, int hq, int hk, int dedup, int n, int bs, int kmax,
                    float scale) {
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
  store_rows<DV>(st, out + qrow0 * DV, qrows, lse ? lse + qrow0 : nullptr);
}

template <typename T, int D, int DV, bool KMASK>
int launch(const void* q, const void* k, const void* v, const int* idx,
           const int* cnt, void* out, float* lse, int b, int hq, int hk, int dedup, int n,
           int bs, int kmax, float scale, cudaStream_t stream) {
  cudaError_t err = prepare<D, DV>(block_sparse_kernel<T, D, DV, KMASK>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n / bs * ((bs + kBQ - 1) / kBQ), hq, b);
  block_sparse_kernel<T, D, DV, KMASK><<<grid, kThreads, sizeof(Smem<D, DV>), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, idx, cnt, (T*)out, lse, hq, hk, dedup, n, bs,
      kmax, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, int DV>
int launch_d(const void* q, const void* k, const void* v, const int* idx,
             const int* cnt, void* out, float* lse, int b, int hq, int hk, int dedup, int n,
             int bs, int kmax, float scale, cudaStream_t stream) {
  if (bs % kBQ == 0)
    return launch<T, D, DV, false>(q, k, v, idx, cnt, out, lse, b, hq, hk, dedup, n, bs,
                                   kmax, scale, stream);
  return launch<T, D, DV, true>(q, k, v, idx, cnt, out, lse, b, hq, hk, dedup, n, bs, kmax,
                                scale, stream);
}

template <typename T>
int launch_tile(const void* q, const void* k, const void* v, const int* idx,
                const int* cnt, void* out, float* lse, int b, int hq, int hk, int dedup, int n,
                int d, int dv, int bs, int kmax, float scale, cudaStream_t stream) {
  STEM_HEAD_DIM_PAIR_SWITCH(d, dv, launch_d<T, D, DV>(q, k, v, idx, cnt, out, lse, b, hq, hk,
                                                      dedup, n, bs, kmax, scale, stream))
}

// bf16 on the tensor cores: the BN-key tiles of the row's live selected
// blocks that hold a key at or below the tile's last query row q0 + 127
// (blocks, q0 and the tiles are multiples of BN: k0 <= q0 + 128 - BN); only
// those that reach row q0's diagonal (off 0, and off 64 past it at BN 64)
// are masked.
template <int BN>
struct SparseTiles {
  const int* ids;
  int live, nq, bs, q0, s, k;     // k: next key offset inside block ids[s]
  __device__ __forceinline__ bool next(int& k0, int& off) {
    while (s < live) {
      const int j = ids[s];
      if (j >= 0 && j < nq && k < bs && j * bs + k <= q0 + (stem_wg::kBM - BN)) {
        k0 = j * bs + k;
        off = k0 - q0;
        k += BN;
        return true;
      }
      ++s;
      k = 0;
    }
    return false;
  }
};

// One instance per shape C of TileOf (head_dims.cuh STEM_WGMMA_PAIR_SWITCH).
// kLse: store each row's log-sum-exp (the training forward); serving runs
// the instance without.
template <class C, bool kLse>
__global__ void __launch_bounds__(stem_wg::kThreads, 1)
block_sparse_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const int* __restrict__ idx, const int* __restrict__ cnt,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int hq,
                          int hk, int dedup, int n, int bs, int kmax, float scale,
                          int tiles_fastest) {
  extern __shared__ uint8_t smem_wg[];
  const int tiles = bs / stem_wg::kBM;
  const int x = tiles_fastest ? gridDim.x - 1 - blockIdx.x   // heaviest query blocks first
                              : gridDim.y - 1 - blockIdx.y;
  const int i = x / tiles, sub = x - i * tiles;
  const int h = tiles_fastest ? blockIdx.y : blockIdx.x, b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const int hsel = dedup ? hk : hq;
  const int nq = n / bs;
  const long long row = ((long long)b * hsel + (dedup ? kvh : h)) * nq + i;
  const int q0 = i * bs + sub * stem_wg::kBM;
  const long long q_row = ((long long)b * hq + h) * n + q0;
  const long long kv_row = ((long long)b * hk + kvh) * n;
  const SparseTiles<C::BN> sel{idx + row * kmax, min(cnt[row], kmax), nq, bs, q0, 0, 0};
  stem_wg::attend_tile<C>(smem_wg, &tq, &tk, &tv, q_row, kv_row, sel, out + q_row * C::DV,
                          stem_wg::kBM, scale, kLse ? lse + q_row : nullptr);
}

template <class C, bool kLse>
int launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                 const int* idx, const int* cnt, void* out, float* lse, int b, int hq, int hk,
                 int dedup, int n, int bs, int kmax, float scale, cudaStream_t stream) {
  cudaError_t err = stem_wg::prepare(block_sparse_wgmma_kernel<C, kLse>, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = n / stem_wg::kBM;
  const int tf = stem_wg::tiles_fastest(2ll * b * hk * n * (C::D + C::DV));
  const dim3 grid = tf ? dim3(tiles, hq, b) : dim3(hq, tiles, b);
  block_sparse_wgmma_kernel<C, kLse><<<grid, stem_wg::kThreads, C::kSmemBytes, stream>>>(
      tq, tk, tv, idx, cnt, (__nv_bfloat16*)out, lse, hq, hk, dedup, n, bs, kmax, scale, tf);
  return (int)cudaGetLastError();
}

template <class C>
int launch_wgmma(const void* q, const void* k, const void* v, const int* idx, const int* cnt,
                 void* out, float* lse, int b, int hq, int hk, int dedup, int n, int bs,
                 int kmax, float scale, cudaStream_t stream) {
  if (bs % stem_wg::kBM != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!stem_wg::make_maps<C>(&tq, &tk, &tv, q, k, v, b, hq, hk, n))
    return (int)cudaErrorInvalidValue;
  return lse ? launch_wgmma<C, true>(tq, tk, tv, idx, cnt, out, lse, b, hq, hk, dedup, n, bs,
                                     kmax, scale, stream)
             : launch_wgmma<C, false>(tq, tk, tv, idx, cnt, out, lse, b, hq, hk, dedup, n, bs,
                                      kmax, scale, stream);
}


// Backward: the key tiles (<= 64 keys of one block) of the row's live
// selected blocks that hold a key at or below the tile's last query row.
struct SparseKeyTiles {
  const int* ids;
  int live, nq, bs, qlast, s, t;
  __device__ __forceinline__ bool next(int& k0, int& krows) {
    while (s < live) {
      const int j = ids[s];
      if (j >= 0 && j < nq && t < bs && j * bs + t <= qlast) {
        k0 = j * bs + t;
        krows = min(stem_bwd::kT, bs - t);
        t += stem_bwd::kT;
        return true;
      }
      ++s;
      t = 0;
    }
    return false;
  }
};

// grid (nq * tiles, hq, b), tiles = ceil(bs / 64)
template <typename T, int D, int DV>
__global__ void __launch_bounds__(stem_bwd::kThreads)
block_sparse_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ o,
                           const T* __restrict__ dout, const int* __restrict__ idx,
                           const int* __restrict__ cnt, T* __restrict__ dq,
                           const float* __restrict__ lse, float* __restrict__ delta, int hq,
                           int hk, int dedup, int n, int bs, int kmax, float scale) {
  extern __shared__ float4 smem_raw[];
  stem_bwd::Smem& sm = *reinterpret_cast<stem_bwd::Smem*>(smem_raw);
  const int tiles = (bs + stem_bwd::kT - 1) / stem_bwd::kT;
  const int i = blockIdx.x / tiles, sub = blockIdx.x - i * tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const int nq = n / bs;
  const long long row = ((long long)b * (dedup ? hk : hq) + (dedup ? kvh : h)) * nq + i;
  const int q0 = i * bs + sub * stem_bwd::kT;
  const int qrows = min(stem_bwd::kT, bs - sub * stem_bwd::kT);
  const long long qrow0 = ((long long)b * hq + h) * n + q0;
  const long long krow0 = ((long long)b * hk + kvh) * n;
  const SparseKeyTiles tl{idx + row * kmax, min(cnt[row], kmax), nq, bs, q0 + qrows - 1, 0, 0};
  stem_bwd::dq_tile<T, D, DV>(sm, q + qrow0 * D, o + qrow0 * DV, dout + qrow0 * DV,
                              k + krow0 * D, v + krow0 * DV, dq + qrow0 * D, lse + qrow0,
                              delta + qrow0, q0, qrows, tl, scale);
}

// grid (nq * tiles, hk, b); tidx (b, h_sel, nq, nq) and tcnt (b, h_sel, nq).
template <typename T, int D, int DV>
__global__ void __launch_bounds__(stem_bwd::kThreads, 1)
block_sparse_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const int* __restrict__ tidx, const int* __restrict__ tcnt,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int hq, int hk, int dedup,
                             int n, int bs, float scale) {
  extern __shared__ float4 smem_raw[];
  stem_bwd::Smem& sm = *reinterpret_cast<stem_bwd::Smem*>(smem_raw);
  const int tiles = (bs + stem_bwd::kT - 1) / stem_bwd::kT;
  const int j = blockIdx.x / tiles, sub = blockIdx.x - j * tiles;
  const int kvh = blockIdx.y, b = blockIdx.z, g = hq / hk;
  const int nq = n / bs;
  const int k0 = j * bs + sub * stem_bwd::kT;
  const int krows = min(stem_bwd::kT, bs - sub * stem_bwd::kT);
  const long long krow0 = ((long long)b * hk + kvh) * n + k0;
  stem_bwd::KVAcc<D, DV> acc;
  stem_bwd::init_acc(acc);
  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    const long long trow = ((long long)b * (dedup ? hk : hq) + (dedup ? kvh : h)) * nq + j;
    const int* list = tidx + trow * nq;
    const int count = min(tcnt[trow], nq);
    const long long hrow = ((long long)b * hq + h) * n;
    for (int u = 0; u < count; ++u) {
      const int i = list[u];
      if (i < 0 || i >= nq) continue;
      for (int t = 0; t < bs; t += stem_bwd::kT) {
        const int q0 = i * bs + t;
        const int qrows = min(stem_bwd::kT, bs - t);
        if (q0 + qrows - 1 < k0) continue;            // every row above these keys
        stem_bwd::dkdv_step<T, D, DV>(sm, acc, k + krow0 * D, v + krow0 * DV, k0, krows,
                                      q + (hrow + q0) * D, dout + (hrow + q0) * DV,
                                      lse + hrow + q0, delta + hrow + q0, q0, qrows, scale);
      }
    }
  }
  stem_bwd::store_acc<D>(dk + krow0 * D, acc.dk, krows, scale);
  stem_bwd::store_acc<DV>(dv + krow0 * DV, acc.dv, krows, 1.f);
}

template <typename T, int D, int DV>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const int* idx, const int* cnt, const int* tidx, const int* tcnt, void* dq,
               void* dk, void* dv, const float* lse, float* delta, int b, int hq, int hk,
               int dedup, int n, int bs, int kmax, float scale, cudaStream_t stream) {
  cudaError_t err = stem_bwd::prepare(block_sparse_bwd_dq_kernel<T, D, DV>);
  if (err == cudaSuccess) err = stem_bwd::prepare(block_sparse_bwd_dkdv_kernel<T, D, DV>);
  if (err != cudaSuccess) return (int)err;
  const int x = n / bs * ((bs + stem_bwd::kT - 1) / stem_bwd::kT);
  block_sparse_bwd_dq_kernel<T, D, DV><<<dim3(x, hq, b), stem_bwd::kThreads,
                                         sizeof(stem_bwd::Smem), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, idx, cnt, (T*)dq,
      lse, delta, hq, hk, dedup, n, bs, kmax, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  block_sparse_bwd_dkdv_kernel<T, D, DV><<<dim3(x, hk, b), stem_bwd::kThreads,
                                           sizeof(stem_bwd::Smem), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, tidx, tcnt, lse, delta, (T*)dk,
      (T*)dv, hq, hk, dedup, n, bs, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_pair(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const int* idx, const int* cnt, const int* tidx,
                    const int* tcnt, void* dq, void* dk, void* dv, const float* lse,
                    float* delta, int b, int hq, int hk, int dedup, int n, int d, int dv_dim,
                    int bs, int kmax, float scale, cudaStream_t stream) {
  STEM_HEAD_DIM_PAIR_SWITCH(d, dv_dim, launch_bwd<T, D, DV>(q, k, v, o, dout, idx, cnt, tidx,
                                                            tcnt, dq, dk, dv, lse, delta, b,
                                                            hq, hk, dedup, n, bs, kmax, scale,
                                                            stream))
}

// Backward on the tensor cores (bf16 at the pairs of STEM_WGMMA_PAIR_SWITCH,
// bs % 128 == 0; shapes stem_bwg::BwdOf<D, DV>): the dq kernel walks the
// forward's key tiles (SparseTiles); the dk / dv kernel, for each query
// head of its KV head (or of its share of them under a head split) in
// turn, the 64-query tiles of the query blocks on its key block's
// transposed list (increasing), skipping tiles wholly above its keys.
struct SparseQueryTiles {
  const int* tidx;
  const int* tcnt;
  long long head_row;              // (b * hq + kvh * g) * n: the group's first head
  long long trow0;                 // the transposed row of head 0 (b, h_sel, key block)
  int g, dedup, n, nq, bs, k0;
  int hh, u, count, t;             // head, list slot, its count, row offset in the block
  __device__ __forceinline__ bool next(long long& row, int& q0) {
    while (hh < g) {
      const long long trow = trow0 + (dedup ? 0 : (long long)hh * nq);
      if (count < 0) count = min(tcnt[trow], nq);
      while (u < count) {
        const int i = tidx[trow * nq + u];
        while (i >= 0 && i < nq && t < bs) {
          const int q = i * bs + t;
          t += stem_bwg::kQT;
          if (q + stem_bwg::kQT - 1 >= k0) {
            row = head_row + (long long)hh * n + q;
            q0 = q;
            return true;
          }
        }
        ++u;
        t = 0;
      }
      ++hh;
      u = 0;
      count = -1;
    }
    return false;
  }
};

// grid (hq, n / 128, b), or (n / 128, hq, b) with tiles_fastest; heaviest
// query blocks first
template <class C>
__global__ void __launch_bounds__(stem_wg::kThreads, 1)
block_sparse_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __nv_bfloat16* __restrict__ o,
                                 const __nv_bfloat16* __restrict__ dout,
                                 const int* __restrict__ idx, const int* __restrict__ cnt,
                                 const float* __restrict__ lse, float* __restrict__ delta,
                                 __nv_bfloat16* __restrict__ dq, int hq, int hk, int dedup,
                                 int n, int bs, int kmax, float scale, int tiles_fastest) {
  extern __shared__ uint8_t smem_wg[];
  const int tiles = bs / stem_wg::kBM;
  const int x = tiles_fastest ? gridDim.x - 1 - blockIdx.x : gridDim.y - 1 - blockIdx.y;
  const int i = x / tiles, sub = x - i * tiles;
  const int h = tiles_fastest ? blockIdx.y : blockIdx.x, b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const int nq = n / bs;
  const long long row = ((long long)b * (dedup ? hk : hq) + (dedup ? kvh : h)) * nq + i;
  const int q0 = i * bs + sub * stem_wg::kBM;
  const long long q_row = ((long long)b * hq + h) * n + q0;
  const long long kv_row = ((long long)b * hk + kvh) * n;
  const SparseTiles<C::BN> sel{idx + row * kmax, min(cnt[row], kmax), nq, bs, q0, 0, 0};
  stem_bwg::dq_tile<C>(smem_wg, &tq, &tdo, &tk, &tv, q_row, kv_row, sel, o + q_row * C::DV,
                       dout + q_row * C::DV, lse + q_row, delta + q_row, dq + q_row * C::D,
                       stem_wg::kBM, scale);
}

// grid (hk * hsplit, n / BK, b), or (n / BK, hk * hsplit, b) with
// tiles_fastest: BK keys of key block y / (bs / BK) a CTA; CTA (kvh, hs) of
// a head split (hsplit > 1, part: its fp32 partials) walks query heads hs *
// g / hsplit .. (hs + 1) * g / hsplit - 1 of the group
template <class C>
__global__ void __launch_bounds__(stem_wg::kThreads, 1)
block_sparse_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tdo,
                                   const int* __restrict__ tidx, const int* __restrict__ tcnt,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                   float* __restrict__ part, int hq, int hk, int dedup, int n,
                                   int bs, float scale, int tiles_fastest, int hsplit) {
  extern __shared__ uint8_t smem_wg[];
  const int kh = tiles_fastest ? blockIdx.y : blockIdx.x, b = blockIdx.z, g = hq / hk;
  const int kvh = kh / hsplit, hs = kh - kvh * hsplit, gs = g / hsplit;
  const int y = tiles_fastest ? blockIdx.x : blockIdx.y;
  const int nq = n / bs;
  const int j = y / (bs / C::BK);
  const int k0 = y * C::BK;
  const long long kv_row = ((long long)b * hk + kvh) * n + k0;
  const long long krows = (long long)gridDim.z * hk * n;
  float* pk = part ? part + ((long long)hs * krows + kv_row) * C::D : nullptr;
  float* pv = part ? part + hsplit * krows * C::D + ((long long)hs * krows + kv_row) * C::DV
                   : nullptr;
  const long long trow0 =
      ((long long)b * (dedup ? hk : hq) + (dedup ? kvh : (long long)kvh * g)) * nq + j;
  const SparseQueryTiles tiles{tidx, tcnt, ((long long)b * hq + (long long)kvh * g) * n, trow0,
                               (hs + 1) * gs, dedup, n, nq, bs, k0, hs * gs, 0, -1, 0};
  stem_bwg::dkdv_tile<C>(smem_wg, &tk, &tv, &tq, &tdo, kv_row, k0, tiles, lse, delta,
                         dk + kv_row * C::D, dv + kv_row * C::DV, pk, pv, n, C::BK, scale);
}

template <int D, int DV>
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const int* idx, const int* cnt, const int* tidx,
                     const int* tcnt, void* dq, void* dk, void* dv, const float* lse,
                     float* delta, float* part, int b, int hq, int hk, int dedup, int n,
                     int bs, int kmax, float scale, cudaStream_t stream) {
  using Q = typename stem_bwg::BwdOf<D, DV>::Dq;
  using K = typename stem_bwg::BwdOf<D, DV>::Dkdv;
  if (bs % stem_wg::kBM != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv, tk2, tv2, tq64, tdo64;
  const long long qrows = (long long)b * hq * n, krows = (long long)b * hk * n;
  if (!stem_wg::make_map(&tq, q, qrows, stem_wg::kBM, D) ||
      !stem_wg::make_map(&tdo, dout, qrows, stem_wg::kBM, DV) ||
      !stem_wg::make_map(&tk, k, krows, Q::BN, D) || !stem_wg::make_map(&tv, v, krows, Q::BN, DV) ||
      !stem_wg::make_map(&tk2, k, krows, K::BK, D) ||
      !stem_wg::make_map(&tv2, v, krows, K::BK, DV) ||
      !stem_wg::make_map(&tq64, q, qrows, stem_bwg::kQT, D) ||
      !stem_wg::make_map(&tdo64, dout, qrows, stem_bwg::kQT, DV))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = stem_wg::prepare(block_sparse_bwd_dq_wgmma_kernel<Q>, Q::kSmemBytes);
  if (err == cudaSuccess)
    err = stem_wg::prepare(block_sparse_bwd_dkdv_wgmma_kernel<K>, K::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int split = stem_bwg::head_split(b, hq, hk, n, K::BK);
  if (split > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  // the dq kernel streams every head's selected K / V, the dk / dv kernel
  // its group's Q / dO
  const int tf_q = stem_wg::tiles_fastest(2ll * b * hk * n * (D + DV));
  const int tf_k = stem_wg::tiles_fastest(2ll * b * hq * n * (D + DV));
  const int qt = n / stem_wg::kBM, kt = n / K::BK;
  block_sparse_bwd_dq_wgmma_kernel<Q><<<tf_q ? dim3(qt, hq, b) : dim3(hq, qt, b),
                                        stem_wg::kThreads, Q::kSmemBytes, stream>>>(
      tq, tdo, tk, tv, (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, idx, cnt, lse,
      delta, (__nv_bfloat16*)dq, hq, hk, dedup, n, bs, kmax, scale, tf_q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  block_sparse_bwd_dkdv_wgmma_kernel<K><<<tf_k ? dim3(kt, hk * split, b)
                                               : dim3(hk * split, kt, b),
                                          stem_wg::kThreads, K::kSmemBytes, stream>>>(
      tk2, tv2, tq64, tdo64, tidx, tcnt, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
      split > 1 ? part : nullptr, hq, hk, dedup, n, bs, scale, tf_k, split);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  return (int)stem_bwg::launch_reduce(part, split, krows, D, DV, dk, dv, scale, stream);
}

}  // namespace

extern "C" {

// q (b, hq, n, d), k (b, hk, n, d), v (b, hk, n, dv), out (b, hq, n, dv);
// idx (b, h_sel, n/bs, kmax) and cnt (b, h_sel, n/bs) int32 with h_sel =
// hk when dedup else hq; all contiguous.  (d, dv) a pair of head_dims.cuh
// and bs dividing n (the wrapper checks).  is_bf16: 0 = float32 (the
// CUDA-core tile), 1 = bfloat16 for q/k/v/out: the tensor-core tile at the
// pairs of STEM_WGMMA_PAIR_SWITCH and bs a multiple of 128 (q, k, v 16-byte
// aligned for TMA), else the CUDA-core tile.  lse: null, or (b, hq, n) fp32 for each row's
// natural-log log-sum-exp.
int stem_block_sparse_attention(const void* q, const void* k, const void* v,
                                const int* idx, const int* cnt, void* out, void* lse, int b,
                                int hq, int hk, int dedup, int n, int d, int dv, int bs,
                                int kmax, int is_bf16, float scale, void* stream) {
  if (hk <= 0 || hq % hk != 0 || bs <= 0 || n % bs != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (is_bf16) {
    if (bs % stem_wg::kBM == 0) {
      STEM_WGMMA_PAIR_SWITCH(d, dv, launch_wgmma<stem_wg::TileOf<D, DV>>(
                                        q, k, v, idx, cnt, out, l, b, hq, hk, dedup, n, bs,
                                        kmax, scale, st))
    }
    return launch_tile<__nv_bfloat16>(q, k, v, idx, cnt, out, l, b, hq, hk, dedup, n, d, dv,
                                      bs, kmax, scale, st);
  }
  return launch_tile<float>(q, k, v, idx, cnt, out, l, b, hq, hk, dedup, n, d, dv, bs, kmax,
                            scale, st);
}

// The head split of the tensor-core backward at this shape (1: none; else
// stem_block_sparse_attention_bwd needs part, split * b * hk * n * (d + dv)
// fp32): 1 off the pairs of STEM_WGMMA_PAIR_SWITCH.
int stem_block_sparse_attention_bwd_split(int b, int hq, int hk, int n, int d, int dv) {
  if (hk <= 0 || hq % hk != 0 || n <= 0) return 1;
  STEM_WGMMA_PAIR_SWITCH(d, dv, stem_bwg::head_split(b, hq, hk, n,
                                                     stem_bwg::BwdOf<D, DV>::Dkdv::BK))
  return 1;
}

// The gradient of stem_block_sparse_attention: q, k, v, idx, cnt, bs,
// kmax as there, o its output and dout o's gradient; tidx (b, h_sel, n/bs,
// n/bs) and tcnt (b, h_sel, n/bs) int32 the transposed selection (the
// first tcnt entries of a row are the query blocks whose live prefix holds
// that key block, increasing); lse (b, hq, n) fp32 the forward's; dq / dk
// / dv shaped as q / k / v in the same dtype; delta (b, hq, n) fp32
// scratch; part: null, or the head split's fp32 scratch (its size above);
// all contiguous.  wgmma: 1 = the tensor-core kernels (bf16 at
// the pairs of STEM_WGMMA_PAIR_SWITCH, bs a multiple of 128 only), 0 = the
// CUDA-core ones.  Two
// launches on the stream (dq and delta, then dk and dv), on `device`
// (stem_bwg::on_device).
int stem_block_sparse_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* o, const void* dout, const void* lse,
                                    const int* idx, const int* cnt, const int* tidx,
                                    const int* tcnt, void* dq, void* dk, void* dv, void* delta,
                                    void* part, int b, int hq, int hk, int dedup, int n, int d,
                                    int dv_dim, int bs, int kmax, int is_bf16, int wgmma,
                                    float scale, void* stream, int device) {
  if (hk <= 0 || hq % hk != 0 || bs <= 0 || n % bs != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  return stem_bwg::on_device(device, [&]() -> int {
    if (wgmma) {
      if (!is_bf16) return (int)cudaErrorInvalidValue;
      STEM_WGMMA_PAIR_SWITCH(d, dv_dim, launch_bwd_wgmma<D, DV>(q, k, v, o, dout, idx, cnt,
                                                                tidx, tcnt, dq, dk, dv, l,
                                                                (float*)delta, (float*)part, b,
                                                                hq, hk, dedup, n, bs, kmax,
                                                                scale, st))
      return (int)cudaErrorInvalidValue;
    }
    if (is_bf16)
      return launch_bwd_pair<__nv_bfloat16>(q, k, v, o, dout, idx, cnt, tidx, tcnt, dq, dk,
                                            dv, l, (float*)delta, b, hq, hk, dedup, n, d,
                                            dv_dim, bs, kmax, scale, st);
    return launch_bwd_pair<float>(q, k, v, o, dout, idx, cnt, tidx, tcnt, dq, dk, dv, l,
                                  (float*)delta, b, hq, hk, dedup, n, d, dv_dim, bs, kmax,
                                  scale, st);
  });
}

}  // extern "C"
