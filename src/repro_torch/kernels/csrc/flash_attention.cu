// Dense causal flash attention with GQA for Hopper (sm_90a): the dense arm of
// the one-shot Stem prefill.
//
// stem_flash_attention replaces _flash_kernel (src/repro/kernels/flash_attention.py:34).
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library with
// a plain C interface (no PyTorch headers), loaded with ctypes.  The entry
// point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() of its launch; the Python wrapper in
// repro_torch/kernels/flash_attention.py checks device, dtype, shape and
// contiguity and holds the plain PyTorch version this kernel is tested
// against.
//
// Bound on the H100: 4 * d flops per (query, key) pair of the causal
// triangle against one read of q, k, v: compute-bound for any prompt of more
// than a few hundred tokens.  The TPU kernel's sequential key-block grid
// axis becomes a loop inside the CTA: one CTA per (64 query rows, query
// head, batch row) walks the key sub-tiles 0..its own diagonal (sub-tiles
// above the diagonal are skipped, the diagonal one is masked exactly), with
// the GQA head mapping kv_head = head / group.  A partial last tile is
// masked (rows past n are neither read nor written), so any n runs.  The
// products run on the fp32 CUDA cores (attn_tile.cuh).
#include "attn_tile.cuh"

namespace {

using namespace stem_attn;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int hq, int hk, int n,
             float scale) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const int q0 = blockIdx.x * kBQ;
  const long long qrow0 = ((long long)b * hq + h) * n + q0;
  const long long krow0 = ((long long)b * hk + kvh) * n;

  load_transposed(sm.qt, q + qrow0 * kD, min(kBQ, n - q0), scale);
  RowState st;
  init_state(st);
  for (int k0 = 0; k0 < n && k0 <= q0 + kBQ - 1; k0 += kBK)
    stage_and_step(sm, st, k + (krow0 + k0) * kD, v + (krow0 + k0) * kD,
                   min(kBK, n - k0), q0, k0);
  store_rows(st, out + qrow0 * kD, min(kBQ, n - q0));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int hq,
           int hk, int n, float scale, cudaStream_t stream) {
  cudaError_t err = prepare(flash_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBQ - 1) / kBQ, hq, b);
  flash_kernel<T><<<grid, kThreads, sizeof(Smem), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, hq, hk, n, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/out (b, hq, n, d), k/v (b, hk, n, d), contiguous; d must be 128 and
// hk must divide hq (the wrapper checks both).  is_bf16: 0 = float32,
// 1 = bfloat16 for all four tensors.
int stem_flash_attention(const void* q, const void* k, const void* v, void* out,
                         int b, int hq, int hk, int n, int d, int is_bf16,
                         float scale, void* stream) {
  if (d != kD || hk <= 0 || hq % hk != 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) return launch<__nv_bfloat16>(q, k, v, out, b, hq, hk, n, scale, st);
  return launch<float>(q, k, v, out, b, hq, hk, n, scale, st);
}

}  // extern "C"
