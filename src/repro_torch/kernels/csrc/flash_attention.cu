// Dense causal flash attention with GQA for Hopper (sm_90a): the dense arm of
// the one-shot Stem prefill.
//
// stem_flash_attention replaces _flash_kernel (src/repro/kernels/flash_attention.py:34).
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library with
// a plain C interface (no PyTorch headers), loaded with ctypes.  The entry
// point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() of its launch; the Python wrapper in
// repro_torch/kernels/flash_attention.py checks device, dtype, shape,
// contiguity and alignment and holds the plain PyTorch version this kernel
// is tested against.
//
// Bound on the H100: 4 * d flops per (query, key) pair of the causal
// triangle against one read of q, k, v: compute-bound for any prompt of more
// than a few hundred tokens.  The TPU kernel's sequential key-block grid
// axis becomes a loop inside the CTA, with the GQA head mapping kv_head =
// head / group.
//
// bf16 (the serving dtype) at the pairs of head_dims.cuh
// STEM_WGMMA_PAIR_SWITCH ((64, 64), (128, 128), MLA's (192, 128) and (192,
// 192), (256, 256)) runs on the tensor cores (attn_wgmma.cuh, one instance
// per pair at its TileOf shape): one CTA per (128 query rows, query head,
// batch row) walks the key tiles (128 or 64 keys) 0..its diagonal through
// a TMA ring, wgmma products and the online softmax in registers; the
// tiles that reach the diagonal are masked exactly, which also masks every
// key past n for the rows < n that are written, so any n runs.  The grid
// walks the query tiles from the last (the heaviest) to the first, with
// the query heads fastest (the g heads of a KV head side by side, the
// causal tail wave holding the light tiles) while the K / V of all heads
// fit twice in L2, else the query tiles of one head fastest (a wave reads
// each key tile once for all of them: deepseek-v3-671b's 128 heads);
// stem_wg::tiles_fastest.  fp32 at every (q/k, v) head_dim pair of
// head_dims.cuh, and bf16 at the narrow pairs (8-32, MLA's reduced (24, 16)
// and (24, 24)), run the CUDA-core tile of attn_tile.cuh (64-row CTAs,
// fp32 products and probabilities: within 1e-4 of the plain version in
// fp32, bf16 loads and stores around the same fp32 math).
//
// Both routes save each row's natural-log log-sum-exp when the caller
// passes an lse buffer (the training path's autograd Function); serving
// passes none, and only the epilogue's store differs.
//
// stem_flash_attention_bwd is the gradient of the same function (the TPU
// kernel has none: the reference trains through XLA's autodiff of its jnp
// attention), two kernels that read the forward's lse and sum without
// atomics.  The wrapper's backward_route picks the route: bf16 at d = dv =
// 128 runs attn_bwd_wgmma.cuh on the tensor
// cores (flash_bwd_dq_wgmma_kernel per 128 query rows over the key tiles
// 0..its diagonal, Q and dO resident, K / V through a TMA ring;
// flash_bwd_dkdv_wgmma_kernel per 128 keys of a KV head over the g query
// heads of its group and the 64-query tiles from its diagonal to the end,
// K and V resident, Q / dO / lse / delta through a TMA ring; P and dS
// rounded to bf16 for the wgmma products).  Every other dtype and pair runs
// attn_bwd.cuh's fp32 CUDA-core tiles, fed the lse of either forward route
// (flash_bwd_dq_kernel per 64 query rows, flash_bwd_dkdv_kernel per 64
// keys, in the same orders).  Bound: 2 *
// (3 d + 2 dv) flops a causal pair (S, dP, dV, dK, dQ); the two kernels do
// 7 products a pair (S and dP in both).
#include "attn_bwd.cuh"
#include "attn_bwd_wgmma.cuh"
#include "attn_tile.cuh"
#include "attn_wgmma.cuh"
#include "head_dims.cuh"

namespace {

using namespace stem_attn;

// q (b, hq, n, D), k (b, hk, n, D), v (b, hk, n, DV), out (b, hq, n, DV).
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, tile_min_ctas<D, DV>())
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse, int hq,
             int hk, int n, float scale) {
  extern __shared__ float4 smem_raw[];
  Smem<D, DV>& sm = *reinterpret_cast<Smem<D, DV>*>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const int q0 = blockIdx.x * kBQ;
  const long long qrow0 = ((long long)b * hq + h) * n + q0;
  const long long krow0 = ((long long)b * hk + kvh) * n;

  load_transposed<D>(sm.qt, q + qrow0 * D, min(kBQ, n - q0), scale);
  RowState<DV> st;
  init_state(st);
  for (int k0 = 0; k0 < n && k0 <= q0 + kBQ - 1; k0 += kBK)
    stage_and_step<D, DV, false>(sm, st, k + (krow0 + k0) * D, v + (krow0 + k0) * DV,
                                 min(kBK, n - k0), q0, k0);
  store_rows<DV>(st, out + qrow0 * DV, min(kBQ, n - q0), lse ? lse + qrow0 : nullptr);
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
           int hq, int hk, int n, float scale, cudaStream_t stream) {
  cudaError_t err = prepare<D, DV>(flash_kernel<T, D, DV>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBQ - 1) / kBQ, hq, b);
  flash_kernel<T, D, DV><<<grid, kThreads, sizeof(Smem<D, DV>), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, hq, hk, n, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                int hq, int hk, int n, int d, int dv, float scale, cudaStream_t stream) {
  STEM_HEAD_DIM_PAIR_SWITCH(d, dv, launch<T, D, DV>(q, k, v, out, lse, b, hq, hk, n, scale,
                                                    stream))
}

// bf16 on the tensor cores: the BN-key tiles 0..last of one query tile
// starting at q0, last the tile of its last valid row; key tile k0 has
// offset k0 - q0, so only the tiles that reach row q0's diagonal (off 0,
// and off 64 past it at BN 64) are masked.
template <int BN>
struct FlashTiles {
  int t, last, q0;
  __device__ __forceinline__ static FlashTiles of(int q0, int n) {
    return FlashTiles{0, (min(q0 + stem_wg::kBM, n) - 1) / BN, q0};
  }
  __device__ __forceinline__ bool next(int& k0, int& off) {
    if (t > last) return false;
    k0 = t * BN;
    off = k0 - q0;
    ++t;
    return true;
  }
};

// One instance per shape C of TileOf (head_dims.cuh STEM_WGMMA_PAIR_SWITCH).
// kLse: store each row's log-sum-exp (the training forward); serving runs
// the instance without, so its tile is compiled as if the store did not
// exist.
template <class C, bool kLse>
__global__ void __launch_bounds__(stem_wg::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, int hq, int hk, int n, float scale,
                   int tiles_fastest) {
  extern __shared__ uint8_t smem_wg[];
  const int h = tiles_fastest ? blockIdx.y : blockIdx.x, b = blockIdx.z;
  const int i = tiles_fastest ? gridDim.x - 1 - blockIdx.x     // heaviest query tiles first
                              : gridDim.y - 1 - blockIdx.y;
  const int kvh = h / (hq / hk);
  const int q0 = i * stem_wg::kBM;
  const long long q_row = ((long long)b * hq + h) * n + q0;
  const long long kv_row = ((long long)b * hk + kvh) * n;
  stem_wg::attend_tile<C>(smem_wg, &tq, &tk, &tv, q_row, kv_row, FlashTiles<C::BN>::of(q0, n),
                          out + q_row * C::DV, min(stem_wg::kBM, n - q0), scale,
                          kLse ? lse + q_row : nullptr);
}

template <class C, bool kLse>
int launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* out,
                 float* lse, int b, int hq, int hk, int n, float scale, cudaStream_t stream) {
  cudaError_t err = stem_wg::prepare(flash_wgmma_kernel<C, kLse>, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + stem_wg::kBM - 1) / stem_wg::kBM;
  const int tf = stem_wg::tiles_fastest(2ll * b * hk * n * (C::D + C::DV));
  const dim3 grid = tf ? dim3(tiles, hq, b) : dim3(hq, tiles, b);
  flash_wgmma_kernel<C, kLse><<<grid, stem_wg::kThreads, C::kSmemBytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, lse, hq, hk, n, scale, tf);
  return (int)cudaGetLastError();
}

template <class C>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                 int hq, int hk, int n, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!stem_wg::make_maps<C>(&tq, &tk, &tv, q, k, v, b, hq, hk, n))
    return (int)cudaErrorInvalidValue;
  return lse ? launch_wgmma<C, true>(tq, tk, tv, out, lse, b, hq, hk, n, scale, stream)
             : launch_wgmma<C, false>(tq, tk, tv, out, lse, b, hq, hk, n, scale, stream);
}

// The tile's two products on one 128 x 128 tile, a test of its shared-memory
// layouts: s = a.b^T as Q.K^T (both K-major) and o = p.v as P.V (p as
// register A fragments, v MN-major), one warpgroup per 64 rows, fp32 out.
__global__ void __launch_bounds__(256, 1)
wgmma_tile_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tv, const __nv_bfloat16* __restrict__ p,
                  float* __restrict__ s_out, float* __restrict__ o_out) {
  namespace wg = stem_wg;
  extern __shared__ uint8_t smem_wg[];
  wg::Smem& sm = wg::aligned_smem(smem_wg);
  if (threadIdx.x == 0) {
    wg::mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::mbar_expect_tx(&sm.q_full, 3 * wg::kTileBytes);
    wg::tma_tile(sm.q, &ta, &sm.q_full, 0);
    wg::tma_tile(sm.k[0], &tb, &sm.q_full, 0);
    wg::tma_tile(sm.v[0], &tv, &sm.q_full, 0);
  }
  wg::mbar_wait(&sm.q_full, 0);
  const int c = threadIdx.x / 128, w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 64 * c + 16 * w + g;
  // accumulator element 4j + 2h + e: row row0 + 8h, column 8j + 2t + e
  float acc[64];
  wg::score_tile(acc, wg::smem_u32(sm.q) + c * 64 * 128, wg::smem_u32(sm.k[0]));
#pragma unroll
  for (int i = 0; i < 64; ++i)
    s_out[(row0 + 8 * ((i >> 1) & 1)) * wg::kD + 8 * (i >> 2) + 2 * t + (i & 1)] = acc[i];
  // A fragment pf[kk][r]: row row0 + 8 (r & 1), columns 16 kk + 8 (r >> 1) + 2t and + 1
  uint32_t pf[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pf[kk][r] = *reinterpret_cast<const uint32_t*>(
          p + (row0 + 8 * (r & 1)) * wg::kD + 16 * kk + 8 * (r >> 1) + 2 * t);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  wg::value_tile(acc, pf, wg::smem_u32(sm.v[0]));
#pragma unroll
  for (int i = 0; i < 64; ++i)
    o_out[(row0 + 8 * ((i >> 1) & 1)) * wg::kD + 8 * (i >> 2) + 2 * t + (i & 1)] = acc[i];
}


// Backward: the key tiles 0..the diagonal of a query tile whose last row is
// at position qlast.
struct FlashKeyTiles {
  int k0, qlast, n;
  __device__ __forceinline__ bool next(int& k, int& krows) {
    if (k0 >= n || k0 > qlast) return false;
    k = k0;
    krows = min(stem_bwd::kT, n - k0);
    k0 += stem_bwd::kT;
    return true;
  }
};

// grid (ceil(n / 64), hq, b)
template <typename T, int D, int DV>
__global__ void __launch_bounds__(stem_bwd::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, T* __restrict__ dq,
                    const float* __restrict__ lse, float* __restrict__ delta, int hq, int hk,
                    int n, float scale) {
  extern __shared__ float4 smem_raw[];
  stem_bwd::Smem& sm = *reinterpret_cast<stem_bwd::Smem*>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const int q0 = blockIdx.x * stem_bwd::kT;
  const int qrows = min(stem_bwd::kT, n - q0);
  const long long qrow0 = ((long long)b * hq + h) * n + q0;
  const long long krow0 = ((long long)b * hk + kvh) * n;
  stem_bwd::dq_tile<T, D, DV>(sm, q + qrow0 * D, o + qrow0 * DV, dout + qrow0 * DV,
                              k + krow0 * D, v + krow0 * DV, dq + qrow0 * D, lse + qrow0,
                              delta + qrow0, q0, qrows, FlashKeyTiles{0, q0 + qrows - 1, n},
                              scale);
}

// grid (ceil(n / 64), hk, b)
template <typename T, int D, int DV>
__global__ void __launch_bounds__(stem_bwd::kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int hq, int hk, int n,
                      float scale) {
  extern __shared__ float4 smem_raw[];
  stem_bwd::Smem& sm = *reinterpret_cast<stem_bwd::Smem*>(smem_raw);
  const int kvh = blockIdx.y, b = blockIdx.z, g = hq / hk;
  const int k0 = blockIdx.x * stem_bwd::kT;
  const int krows = min(stem_bwd::kT, n - k0);
  const long long krow0 = ((long long)b * hk + kvh) * n + k0;
  stem_bwd::KVAcc<D, DV> acc;
  stem_bwd::init_acc(acc);
  for (int hh = 0; hh < g; ++hh) {
    const long long hrow = ((long long)b * hq + kvh * g + hh) * n;
    for (int q0 = k0; q0 < n; q0 += stem_bwd::kT)
      stem_bwd::dkdv_step<T, D, DV>(sm, acc, k + krow0 * D, v + krow0 * DV, k0, krows,
                                    q + (hrow + q0) * D, dout + (hrow + q0) * DV,
                                    lse + hrow + q0, delta + hrow + q0, q0,
                                    min(stem_bwd::kT, n - q0), scale);
  }
  stem_bwd::store_acc<D>(dk + krow0 * D, acc.dk, krows, scale);
  stem_bwd::store_acc<DV>(dv + krow0 * DV, acc.dv, krows, 1.f);
}

template <typename T, int D, int DV>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               void* dq, void* dk, void* dv, const float* lse, float* delta, int b, int hq,
               int hk, int n, float scale, cudaStream_t stream) {
  cudaError_t err = stem_bwd::prepare(flash_bwd_dq_kernel<T, D, DV>);
  if (err == cudaSuccess) err = stem_bwd::prepare(flash_bwd_dkdv_kernel<T, D, DV>);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + stem_bwd::kT - 1) / stem_bwd::kT;
  flash_bwd_dq_kernel<T, D, DV><<<dim3(tiles, hq, b), stem_bwd::kThreads,
                                  sizeof(stem_bwd::Smem), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, (T*)dq, lse, delta,
      hq, hk, n, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<T, D, DV><<<dim3(tiles, hk, b), stem_bwd::kThreads,
                                    sizeof(stem_bwd::Smem), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, hq,
      hk, n, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_pair(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, void* dq, void* dk, void* dv, const float* lse,
                    float* delta, int b, int hq, int hk, int n, int d, int dv_dim, float scale,
                    cudaStream_t stream) {
  STEM_HEAD_DIM_PAIR_SWITCH(d, dv_dim, launch_bwd<T, D, DV>(q, k, v, o, dout, dq, dk, dv, lse,
                                                            delta, b, hq, hk, n, scale,
                                                            stream))
}

// Backward on the tensor cores (bf16, d = dv = 128): the dq kernel walks
// the forward's key tiles (FlashTiles); the dk / dv kernel the 64-query
// tiles of each query head of its KV head, from its diagonal to the end.
struct FlashQueryTiles {
  long long head_row;              // (b * hq + kvh * g) * n: the group's first head
  int g, n, first, hh, q;
  __device__ __forceinline__ bool next(long long& row, int& q0) {
    if (q >= n) {
      if (++hh >= g) return false;
      q = first;
    }
    row = head_row + (long long)hh * n + q;
    q0 = q;
    q += stem_bwg::kQT;
    return true;
  }
};

// grid (hq, ceil(n / 128), b), heaviest query tiles first
__global__ void __launch_bounds__(stem_wg::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int hq, int hk, int n, float scale) {
  extern __shared__ uint8_t smem_wg[];
  const int h = blockIdx.x, b = blockIdx.z;
  const int i = gridDim.y - 1 - blockIdx.y;
  const int kvh = h / (hq / hk);
  const int q0 = i * stem_wg::kBM;
  const long long q_row = ((long long)b * hq + h) * n + q0;
  const long long kv_row = ((long long)b * hk + kvh) * n;
  stem_bwg::dq_tile(smem_wg, &tq, &tdo, &tk, &tv, q_row, kv_row,
                    FlashTiles<stem_wg::kBN>::of(q0, n),
                    o + q_row * stem_wg::kD, dout + q_row * stem_wg::kD, lse + q_row,
                    delta + q_row, dq + q_row * stem_wg::kD, min(stem_wg::kBM, n - q0), scale);
}

// grid (hk, ceil(n / 128), b): key tile 0 (the most query tiles) first
__global__ void __launch_bounds__(stem_wg::kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            int hq, int hk, int n, float scale) {
  extern __shared__ uint8_t smem_wg[];
  const int kvh = blockIdx.x, b = blockIdx.z, g = hq / hk;
  const int k0 = blockIdx.y * stem_wg::kBN;
  const long long kv_row = ((long long)b * hk + kvh) * n + k0;
  const FlashQueryTiles tiles{((long long)b * hq + (long long)kvh * g) * n, g, n, k0, 0, k0};
  stem_bwg::dkdv_tile(smem_wg, &tk, &tv, &tq, &tdo, kv_row, k0, tiles, lse, delta,
                      dk + kv_row * stem_wg::kD, dv + kv_row * stem_wg::kD, n,
                      min(stem_wg::kBN, n - k0), scale);
}

int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, void* dq, void* dk, void* dv, const float* lse,
                     float* delta, int b, int hq, int hk, int n, float scale,
                     cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv, tq64, tdo64;
  const long long qrows = (long long)b * hq * n, krows = (long long)b * hk * n;
  if (!stem_wg::make_map(&tq, q, qrows) || !stem_wg::make_map(&tdo, dout, qrows) ||
      !stem_wg::make_map(&tk, k, krows) || !stem_wg::make_map(&tv, v, krows) ||
      !stem_wg::make_map(&tq64, q, qrows, stem_bwg::kQT) ||
      !stem_wg::make_map(&tdo64, dout, qrows, stem_bwg::kQT))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = stem_wg::prepare(flash_bwd_dq_wgmma_kernel, stem_bwg::kDqSmemBytes);
  if (err == cudaSuccess)
    err = stem_wg::prepare(flash_bwd_dkdv_wgmma_kernel, stem_bwg::kDkdvSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + stem_wg::kBM - 1) / stem_wg::kBM;
  flash_bwd_dq_wgmma_kernel<<<dim3(hq, tiles, b), stem_wg::kThreads, stem_bwg::kDqSmemBytes,
                              stream>>>(tq, tdo, tk, tv, (const __nv_bfloat16*)o,
                                        (const __nv_bfloat16*)dout, lse, delta,
                                        (__nv_bfloat16*)dq, hq, hk, n, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_wgmma_kernel<<<dim3(hk, tiles, b), stem_wg::kThreads,
                                stem_bwg::kDkdvSmemBytes, stream>>>(
      tk, tv, tq64, tdo64, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, hq, hk, n,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (b, hq, n, d), k (b, hk, n, d), v (b, hk, n, dv), out (b, hq, n, dv),
// contiguous; (d, dv) a pair of head_dims.cuh and hk dividing hq (the
// wrapper checks both).  is_bf16: 0 = float32 (the CUDA-core tile), 1 =
// bfloat16 for all four tensors (the tensor-core tile at the pairs of
// STEM_WGMMA_PAIR_SWITCH, q, k, v 16-byte aligned for TMA; the CUDA-core
// tile at the other pairs).
// lse: null, or (b, hq, n) fp32 for each row's natural-log log-sum-exp.
int stem_flash_attention(const void* q, const void* k, const void* v, void* out,
                         void* lse, int b, int hq, int hk, int n, int d, int dv, int is_bf16,
                         float scale, void* stream) {
  if (hk <= 0 || hq % hk != 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (is_bf16) {
    STEM_WGMMA_PAIR_SWITCH(d, dv, launch_wgmma<stem_wg::TileOf<D, DV>>(q, k, v, out, l, b, hq,
                                                                      hk, n, scale, st))
    return launch_tile<__nv_bfloat16>(q, k, v, out, l, b, hq, hk, n, d, dv, scale, st);
  }
  return launch_tile<float>(q, k, v, out, l, b, hq, hk, n, d, dv, scale, st);
}

// a, b, p, v: (128, 128) bf16, contiguous and 16-byte aligned; s, o:
// (128, 128) fp32.  s = a.b^T and o = p.v through the tensor-core tile.
int stem_wgmma_tile_products(const void* a, const void* b, const void* p, const void* v,
                             void* s, void* o, void* stream) {
  CUtensorMap ta, tb, tv;
  if (!stem_wg::make_map(&ta, a, 128) || !stem_wg::make_map(&tb, b, 128) ||
      !stem_wg::make_map(&tv, v, 128))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = stem_wg::prepare(wgmma_tile_kernel);
  if (err != cudaSuccess) return (int)err;
  wgmma_tile_kernel<<<1, 256, stem_wg::kSmemBytes, (cudaStream_t)stream>>>(
      ta, tb, tv, (const __nv_bfloat16*)p, (float*)s, (float*)o);
  return (int)cudaGetLastError();
}

// The gradient of stem_flash_attention: q, k, v, o (its output), dout
// (o's gradient) as there, lse (b, hq, n) fp32 the forward's, dq / dk / dv
// shaped as q / k / v in the same dtype, delta (b, hq, n) fp32 scratch; all
// contiguous.  wgmma: 1 = the tensor-core kernels (bf16, d = dv = 128 only;
// anything else is refused), 0 = the CUDA-core ones.  Two launches on the
// stream (dq and delta, then dk and dv).
int stem_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* dq, void* dk, void* dv,
                             void* delta, int b, int hq, int hk, int n, int d, int dv_dim,
                             int is_bf16, int wgmma, float scale, void* stream) {
  if (hk <= 0 || hq % hk != 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  if (wgmma) {
    if (!is_bf16 || d != stem_wg::kD || dv_dim != stem_wg::kD) return (int)cudaErrorInvalidValue;
    return launch_bwd_wgmma(q, k, v, o, dout, dq, dk, dv, l, (float*)delta, b, hq, hk, n, scale,
                            st);
  }
  if (is_bf16)
    return launch_bwd_pair<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, (float*)delta, b,
                                          hq, hk, n, d, dv_dim, scale, st);
  return launch_bwd_pair<float>(q, k, v, o, dout, dq, dk, dv, l, (float*)delta, b, hq, hk, n,
                                d, dv_dim, scale, st);
}

}  // extern "C"
