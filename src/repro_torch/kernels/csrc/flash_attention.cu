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
// bf16 (the serving dtype) at head_dim 128 runs on the tensor cores
// (attn_wgmma.cuh): one CTA per (128 query rows, query head, batch row) walks
// the key tiles 0..its diagonal through a TMA ring, wgmma products and the
// online softmax in registers; the diagonal tile is masked exactly, which
// also masks every key past n for the rows < n that are written, so any n
// runs.  The grid puts the query heads fastest, so the g heads of a KV head
// run side by side and the second read of each K/V tile comes from L2, and
// walks the query tiles from the last (the heaviest) to the first, so the
// causal tail wave holds the light tiles.  fp32 at every (q/k, v) head_dim
// pair of head_dims.cuh, and bf16 at every pair but (128, 128) (8-64 and
// 256, and MLA's q/k 24 or 192 with v 16, 24, 128 or 192), run the
// CUDA-core tile of attn_tile.cuh (64-row CTAs, fp32 products and probabilities:
// within 1e-4 of the plain version in fp32, bf16 loads and stores around
// the same fp32 math).
#include "attn_tile.cuh"
#include "attn_wgmma.cuh"
#include "head_dims.cuh"

namespace {

using namespace stem_attn;

// q (b, hq, n, D), k (b, hk, n, D), v (b, hk, n, DV), out (b, hq, n, DV).
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, tile_min_ctas<D, DV>())
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int hq, int hk, int n,
             float scale) {
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
  store_rows<DV>(st, out + qrow0 * DV, min(kBQ, n - q0));
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int b, int hq,
           int hk, int n, float scale, cudaStream_t stream) {
  cudaError_t err = prepare<D, DV>(flash_kernel<T, D, DV>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBQ - 1) / kBQ, hq, b);
  flash_kernel<T, D, DV><<<grid, kThreads, sizeof(Smem<D, DV>), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, hq, hk, n, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile(const void* q, const void* k, const void* v, void* out, int b, int hq,
                int hk, int n, int d, int dv, float scale, cudaStream_t stream) {
  STEM_HEAD_DIM_PAIR_SWITCH(d, dv, launch<T, D, DV>(q, k, v, out, b, hq, hk, n, scale,
                                                    stream))
}

// bf16 on the tensor cores: the key tiles 0..last of one query tile; only
// the diagonal one (off 0) is masked.
struct FlashTiles {
  int t, last;
  __device__ __forceinline__ bool next(int& k0, int& off) {
    if (t > last) return false;
    k0 = t * stem_wg::kBN;
    off = (t - last) * stem_wg::kBN;
    ++t;
    return true;
  }
};

__global__ void __launch_bounds__(stem_wg::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                   int hq, int hk, int n, float scale) {
  extern __shared__ uint8_t smem_wg[];
  const int h = blockIdx.x, b = blockIdx.z;
  const int i = gridDim.y - 1 - blockIdx.y;          // heaviest query tiles first
  const int kvh = h / (hq / hk);
  const int q0 = i * stem_wg::kBM;
  const long long q_row = ((long long)b * hq + h) * n + q0;
  const long long kv_row = ((long long)b * hk + kvh) * n;
  stem_wg::attend_tile(smem_wg, &tq, &tk, &tv, q_row, kv_row, FlashTiles{0, i},
                       out + q_row * stem_wg::kD, min(stem_wg::kBM, n - q0), scale);
}

int launch_wgmma(const void* q, const void* k, const void* v, void* out, int b, int hq,
                 int hk, int n, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!stem_wg::make_maps(&tq, &tk, &tv, q, k, v, b, hq, hk, n))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = stem_wg::prepare(flash_wgmma_kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq, (n + stem_wg::kBM - 1) / stem_wg::kBM, b);
  flash_wgmma_kernel<<<grid, stem_wg::kThreads, stem_wg::kSmemBytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, hq, hk, n, scale);
  return (int)cudaGetLastError();
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

}  // namespace

extern "C" {

// q (b, hq, n, d), k (b, hk, n, d), v (b, hk, n, dv), out (b, hq, n, dv),
// contiguous; (d, dv) a pair of head_dims.cuh and hk dividing hq (the
// wrapper checks both).  is_bf16: 0 = float32 (the CUDA-core tile), 1 =
// bfloat16 for all four tensors (the tensor-core tile at d = dv = 128, q,
// k, v 16-byte aligned for TMA; the CUDA-core tile at the other pairs).
int stem_flash_attention(const void* q, const void* k, const void* v, void* out,
                         int b, int hq, int hk, int n, int d, int dv, int is_bf16,
                         float scale, void* stream) {
  if (hk <= 0 || hq % hk != 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16 && d == stem_wg::kD && dv == stem_wg::kD)
    return launch_wgmma(q, k, v, out, b, hq, hk, n, scale, st);
  if (is_bf16)
    return launch_tile<__nv_bfloat16>(q, k, v, out, b, hq, hk, n, d, dv, scale, st);
  return launch_tile<float>(q, k, v, out, b, hq, hk, n, d, dv, scale, st);
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

}  // extern "C"
