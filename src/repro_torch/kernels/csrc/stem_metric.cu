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
// repro_torch/kernels/stem_metric.py check device, dtype, shape, contiguity
// and alignment and hold the plain PyTorch versions these kernels are tested
// against.
//
// Bound on the H100: both read each input element once and do one (pool) or
// two (vmag) flops on it, so both are bytes-bound: at a 16384-token prompt
// (16 heads, d 128, bf16) the pool moves 67 MB in and 8.4 MB out, 0.0225 ms
// at 3.35 TB/s.
//
// pool_kernel keeps that bound in reach with wide loads and many threads:
// a thread owns a strip of VEC consecutive head_dim columns of one residue
// row u of one (batch x head, block) slab, 16 bytes of input (8 bf16 or 4
// fp32), reads the bs / s rows of its strip (g * s + u, g < bs / s) in a
// loop unrolled 8 deep, sums in fp32 and writes the strip's means with
// 16-byte stores (fp32, or rounded to the input's bf16 where the caller
// replaces a mean that keeps q's dtype).  A warp's load covers 512
// contiguous bytes.  Loads and stores are cache-streaming (each byte is
// touched once).  The kernel stays at 30-40 registers, so 12-16 CTAs of 128
// threads share an SM and the loads in flight come from the many threads
// (holding all 8 loads of a strip in registers took 56-68 registers, half
// the CTAs an SM, and was slower).  The grid is the strips over 128
// threads, capped at the CTAs the card holds at once, each CTA striding
// over the rest: a 16k prompt runs in a few rounds of resident CTAs, and
// the serving lanes' small calls (128 slabs of a 1024-token chunk, 256 or
// 128 CTAs) still spread over every SM.  A view that is not 16-byte aligned, or a row that is not a
// whole number of 16-byte strips, runs the same kernel with VEC = 1
// (scalar loads).  vmag_kernel: one CTA per (block of bs tokens, batch x
// head); each warp reduces whole rows, lanes on neighbouring columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

constexpr int kPoolThreads = 128;

// A strip of VEC elements of T read as one load (16 bytes for VEC > 1) and
// widened to fp32, or VEC fp32 values narrowed to T and written with 16-byte
// (8-byte for 4 bf16) stores.  The wide loads and stores are cache-streaming
// (ld/st.global.cs: each byte is touched once, so it is marked to leave the
// caches first).
template <typename T, int VEC> struct Strip;
template <> struct Strip<float, 4> {
  using raw = float4;
  __device__ static raw load(const float* p) { return __ldcs(reinterpret_cast<const raw*>(p)); }
  __device__ static void widen(const raw& r, float (&x)[4]) {
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  }
  __device__ static void store(float* p, const float (&x)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  }
};
template <> struct Strip<__nv_bfloat16, 8> {
  using raw = uint4;
  __device__ static raw load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const raw*>(p));
  }
  __device__ static void widen(const raw& r, float (&x)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&x)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    __stcs(reinterpret_cast<uint4*>(p), r);
  }
};
template <typename T> struct Strip<T, 1> {
  using raw = T;
  __device__ static raw load(const T* p) { return *p; }
  __device__ static void widen(const raw& r, float (&x)[1]) { x[0] = to_f32(r); }
  __device__ static void store(T* p, const float (&x)[1]) { *p = from_f32<T>(x[0]); }
};
// Outputs of a 16-byte input strip: fp32 from 8 bf16 (two stores), bf16
// from 4 fp32 (one 8-byte store).
template <> struct Strip<float, 8> {
  __device__ static void store(float* p, const float (&x)[8]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(x[4], x[5], x[6], x[7]));
  }
};
template <> struct Strip<__nv_bfloat16, 4> {
  __device__ static void store(__nv_bfloat16* p, const float (&x)[4]) {
    uint2 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
    h[0] = __floats2bfloat162_rn(x[0], x[1]);
    h[1] = __floats2bfloat162_rn(x[2], x[3]);
    __stcs(reinterpret_cast<uint2*>(p), r);
  }
};

// out[bh, blk, u, c] = mean_{g < bs/s} x[bh, blk*bs + g*s + u, c].
// Strip i of the (bh * n/bs) slabs of s * d / VEC strips each; a 1-D grid
// strides over them.  x, out 16-byte aligned and d % VEC == 0 when VEC > 1.
template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(kPoolThreads)
pool_kernel(const Tin* __restrict__ x, Tout* __restrict__ out, long long strips,
            int d, int bs, int s) {
  using In = Strip<Tin, VEC>;
  const int per = bs / s, sd = s * d;
  const int slab_strips = sd / VEC;
  const long long row_step = (long long)s * d;
  for (long long i = (long long)blockIdx.x * kPoolThreads + threadIdx.x; i < strips;
       i += (long long)gridDim.x * kPoolThreads) {
    const long long slab = i / slab_strips;
    const int o = (int)(i - slab * slab_strips) * VEC;    // u * d + c
    const Tin* src = x + slab * bs * (long long)d + o;  // row u of the slab, column c
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll 8
    for (int g = 0; g < per; ++g) {
      float v[VEC];
      In::widen(In::load(src + g * row_step), v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += v[e];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] /= (float)per;
    Strip<Tout, VEC>::store(out + slab * sd + o, acc);
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

// CTAs of pool_kernel<Tin, Tout, VEC> the card holds at once (queried once
// a process).
template <typename Tin, typename Tout, int VEC>
int pool_grid_cap() {
  static int cap = 0;
  if (cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pool_kernel<Tin, Tout, VEC>,
                                                  kPoolThreads, 0);
    cap = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  }
  return cap;
}

template <typename Tin, typename Tout, int VEC>
int launch_pool(const void* x, void* out, int bh, int n, int d, int bs, int s,
                cudaStream_t stream) {
  const long long strips = (long long)bh * (n / bs) * s * (d / VEC);
  const long long want = (strips + kPoolThreads - 1) / kPoolThreads;
  const int grid = (int)(want < pool_grid_cap<Tin, Tout, VEC>()
                             ? want : pool_grid_cap<Tin, Tout, VEC>());
  pool_kernel<Tin, Tout, VEC><<<grid, kPoolThreads, 0, stream>>>(
      (const Tin*)x, (Tout*)out, strips, d, bs, s);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch_pool_vec(const void* x, void* out, int bh, int n, int d, int bs, int s,
                    int vec, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(Tin);
  if (vec == 1) return launch_pool<Tin, Tout, 1>(x, out, bh, n, d, bs, s, stream);
  if (vec != kVec || d % kVec != 0 || (uintptr_t)x % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return launch_pool<Tin, Tout, kVec>(x, out, bh, n, d, bs, s, stream);
}

}  // namespace

extern "C" {

// x (bh, n, d) contiguous -> out (bh, n/bs, s, d); s divides bs, bs divides
// n.  in_bf16 / out_bf16: 0 = float32, 1 = bfloat16.  vec: elements a thread
// loads at once, 16 / sizeof(input) (x and out 16-byte aligned, d a multiple
// of it) or 1 (scalar loads, any alignment).
int stem_antidiag_pool(const void* x, void* out, int bh, int n, int d, int bs, int s,
                       int in_bf16, int out_bf16, int vec, void* stream) {
  if (bs <= 0 || s <= 0 || bs % s != 0 || n % bs != 0 || bh <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bf16 && out_bf16)
    return launch_pool_vec<__nv_bfloat16, __nv_bfloat16>(x, out, bh, n, d, bs, s, vec, st);
  if (in_bf16)
    return launch_pool_vec<__nv_bfloat16, float>(x, out, bh, n, d, bs, s, vec, st);
  if (out_bf16)
    return launch_pool_vec<float, __nv_bfloat16>(x, out, bh, n, d, bs, s, vec, st);
  return launch_pool_vec<float, float>(x, out, bh, n, d, bs, s, vec, st);
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
