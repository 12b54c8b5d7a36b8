// Stem metric downsampling kernels for Hopper (sm_90a): anti-diagonal group
// means and block max of log ||V_j||_2.
//
// stem_antidiag_pool     replaces _pool_kernel (src/repro/kernels/stem_metric.py:27)
// stem_value_magnitude   replaces _vmag_kernel (src/repro/kernels/stem_metric.py:57)
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library with
// a plain C interface (no PyTorch headers), loaded with ctypes.  Each entry
// point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() of its launch; the Python wrappers in
// repro_torch/kernels/stem_metric.py check device, dtype, shape and
// contiguity and hold the plain PyTorch versions these kernels are tested
// against.
//
// Bound on the H100: both read each input element once and do one (pool) or
// two (vmag) flops on it: bytes-bound.  One CTA per (block of bs tokens,
// batch x head) reads its bs x d slab once with neighbouring threads on
// neighbouring head_dim columns (coalesced), sums in fp32 and writes the
// s x d group means (in the output dtype: fp32, or rounded to the input's
// bf16 where the caller replaces a mean that keeps q's dtype) or one fp32
// block maximum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// out[bh, blk, u, c] = mean_{g < bs/s} x[bh, blk*bs + g*s + u, c].
// grid (n / bs, b * h).
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
pool_kernel(const Tin* __restrict__ x, Tout* __restrict__ out, int n, int d, int bs,
            int s) {
  const int blk = blockIdx.x;
  const long long bh = blockIdx.y;
  const int nb = n / bs, per = bs / s;
  const Tin* src = x + (bh * n + (long long)blk * bs) * d;
  Tout* dst = out + (bh * nb + blk) * (long long)s * d;
  for (int o = threadIdx.x; o < s * d; o += blockDim.x) {
    const int u = o / d, c = o - u * d;
    float acc = 0.f;
    for (int g = 0; g < per; ++g) acc += to_f32(src[(long long)(g * s + u) * d + c]);
    dst[o] = from_f32<Tout>(acc / (float)per);
  }
}

// out[bh, blk] = max_{j in block} log(max(||v[bh, j]||_2, 1e-20)).
// grid (n / bs, b * h); each warp reduces whole rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
vmag_kernel(const T* __restrict__ v, float* __restrict__ out, int n, int d, int bs) {
  __shared__ float warp_max[kThreads / kWarp];
  const int blk = blockIdx.x;
  const long long bh = blockIdx.y;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nw = blockDim.x / kWarp;
  const T* src = v + (bh * n + (long long)blk * bs) * d;
  float best = -INFINITY;
  for (int r = warp; r < bs; r += nw) {
    float ss = 0.f;
    for (int c = lane; c < d; c += kWarp) {
      const float e = to_f32(src[(long long)r * d + c]);
      ss = fmaf(e, e, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    best = fmaxf(best, logf(fmaxf(sqrtf(ss), 1e-20f)));
  }
  if (lane == 0) warp_max[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < nw; ++w) m = fmaxf(m, warp_max[w]);
    out[bh * (n / bs) + blk] = m;
  }
}

template <typename Tin, typename Tout>
int launch_pool(const void* x, void* out, int bh, int n, int d, int bs, int s,
                cudaStream_t stream) {
  pool_kernel<Tin, Tout><<<dim3(n / bs, bh), kThreads, 0, stream>>>(
      (const Tin*)x, (Tout*)out, n, d, bs, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (bh, n, d) contiguous -> out (bh, n/bs, s, d); s divides bs, bs divides
// n, bh <= 65535.  in_bf16 / out_bf16: 0 = float32, 1 = bfloat16.
int stem_antidiag_pool(const void* x, void* out, int bh, int n, int d, int bs, int s,
                       int in_bf16, int out_bf16, void* stream) {
  if (bs <= 0 || s <= 0 || bs % s != 0 || n % bs != 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bf16 && out_bf16)
    return launch_pool<__nv_bfloat16, __nv_bfloat16>(x, out, bh, n, d, bs, s, st);
  if (in_bf16) return launch_pool<__nv_bfloat16, float>(x, out, bh, n, d, bs, s, st);
  if (out_bf16) return launch_pool<float, __nv_bfloat16>(x, out, bh, n, d, bs, s, st);
  return launch_pool<float, float>(x, out, bh, n, d, bs, s, st);
}

// v (bh, n, d) contiguous -> out (bh, n/bs) float32.
int stem_value_magnitude(const void* v, float* out, int bh, int n, int d, int bs,
                         int is_bf16, void* stream) {
  if (bs <= 0 || n % bs != 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(n / bs, bh);
  if (is_bf16)
    vmag_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)v, out, n, d, bs);
  else
    vmag_kernel<float><<<grid, kThreads, 0, st>>>((const float*)v, out, n, d, bs);
  return (int)cudaGetLastError();
}

}  // extern "C"
