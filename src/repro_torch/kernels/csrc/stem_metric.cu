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
// (scalar loads).
//
// vmag_kernel reads each element once for two flops: bytes-bound (a 16k
// prompt's v, 8 KV heads, d 128, bf16: 33.5 MB, 0.0100 ms at 3.35 TB/s).
// It takes the pool's design: a thread owns a 16-byte strip of a row (the
// d / 8 bf16 or d / 4 fp32 strips of a row are lanes of one warp, d / 4 =
// 64 fp32 strips two a lane), loads are cache-streaming, a thread loads
// the strips of 4 of its rows before it reduces any (128-thread CTAs at
// 31-64 registers, 8 or more an SM, so one wave holds every block of a 16k
// prompt; loading a row at a time in 256-thread CTAs was slower at every
// shape, 8 rows a batch no faster), and the lanes of a row sum its squared
// norm with shuffles across the row's lanes only.
// Each thread keeps the running max of its rows' squared norms, and one
// sqrt and one log run a block, at the end (both monotone, so the max
// commutes with them).  The grid is capped at the resident CTAs, each CTA
// striding over the (batch x head, block) units; where the units are fewer
// than the SMs (a 1024-token chunk of the serving lanes: 64 blocks), a
// thread-block cluster of 2 or 4 CTAs splits each block's rows and rank 0
// takes the max of the ranks' maxima from distributed shared memory, so
// the call covers the card without a second launch.  A view that is not
// 16-byte aligned, or a row that is not a power-of-two number of 16-byte
// strips (at most 64), runs the same kernel on scalar loads.  An all-zero
// block gives log(1e-20), as metric.value_block_magnitude does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kPoolThreads = 128;
constexpr int kVmagThreads = 128;
constexpr int kVmagBatch = 4;                // rows a thread loads before reducing
constexpr int kVmagMaxParts = 4;             // CTAs of a vmag cluster

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

// Sum of squares of a loaded strip of VEC elements.
template <typename T, int VEC>
__device__ __forceinline__ float strip_sq(const typename Strip<T, VEC>::raw& r) {
  float x[VEC];
  Strip<T, VEC>::widen(r, x);
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < VEC; ++e) ss = fmaf(x[e], x[e], ss);
  return ss;
}

// out[u] = max_{j in block u} log(max(||v[u * bs + j]||_2, 1e-20)) over the
// units u = (batch x head, block) of a (bh, n, d) tensor, as
// log(max(sqrt(max_j ||v_j||^2), 1e-20)): sqrt and log are monotone, so one
// of each a block.  A thread owns strip li (and li + lpr, ... : CPT strips,
// or every lpr-th element in the scalar variant, CPT = 0) of rows rsub,
// rsub + rpp, ... of its rank's rows, and loads the strips of kVmagBatch of
// them before it reduces any (the loads of a batch are in flight together);
// the lpr lanes of a row reduce its squared norm with shuffles, each thread
// keeps the running max, the CTA's max meets in shared memory.  With parts > 1 a thread-block cluster of
// `parts` CTAs splits each block's rows and the ranks' maxima meet in rank
// 0's shared memory (distributed shared memory, one cluster barrier a
// block).  The 1-D grid of clusters strides over the units.
template <typename T, int VEC, int CPT>
__global__ void __launch_bounds__(kVmagThreads)
vmag_kernel(const T* __restrict__ v, float* __restrict__ out, long long units, int d,
            int bs, int lpr, int parts) {
  __shared__ float warp_best[2][kVmagThreads / kWarp];
  __shared__ float part_best[2][kVmagMaxParts];
  const int spr = d / VEC;                           // strips a row
  const int li = threadIdx.x % lpr, rsub = threadIdx.x / lpr;
  const int rpp = kVmagThreads / lpr;                // rows a pass
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const unsigned group = lpr == kWarp ? 0xffffffffu
                                      : ((1u << lpr) - 1u) << (lane & ~(lpr - 1));
  const int rank = blockIdx.x % parts, rows = bs / parts;
  const int r_begin = rank * rows, r_end = r_begin + rows;
  int it = 0;
  for (long long u = blockIdx.x / parts; u < units; u += gridDim.x / parts, ++it) {
    const T* base = v + u * bs * d;
    float best = 0.f;                                // max squared norm
    for (int r0 = r_begin + rsub; r0 < r_end; r0 += kVmagBatch * rpp) {
      float ss[kVmagBatch];
      if constexpr (CPT > 0) {
        typename Strip<T, VEC>::raw x[kVmagBatch][CPT];
#pragma unroll
        for (int b = 0; b < kVmagBatch; ++b) {
          const T* row = base + (long long)(r0 + b * rpp) * d + li * VEC;
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            if (r0 + b * rpp < r_end) x[b][c] = Strip<T, VEC>::load(row + c * lpr * VEC);
        }
#pragma unroll
        for (int b = 0; b < kVmagBatch; ++b) {
          ss[b] = 0.f;
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            if (r0 + b * rpp < r_end) ss[b] += strip_sq<T, VEC>(x[b][c]);
        }
      } else {
#pragma unroll
        for (int b = 0; b < kVmagBatch; ++b) {
          ss[b] = 0.f;
          if (r0 + b * rpp >= r_end) continue;
          const T* row = base + (long long)(r0 + b * rpp) * d;
          for (int c = li; c < spr; c += lpr) ss[b] += strip_sq<T, 1>(Strip<T, 1>::load(row + c));
        }
      }
      for (int o = lpr / 2; o > 0; o >>= 1)
#pragma unroll
        for (int b = 0; b < kVmagBatch; ++b) ss[b] += __shfl_xor_sync(group, ss[b], o);
#pragma unroll
      for (int b = 0; b < kVmagBatch; ++b) best = fmaxf(best, ss[b]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
    if (lane == 0) warp_best[it & 1][warp] = best;
    __syncthreads();                                 // (buffers alternate: one barrier a unit)
    if (threadIdx.x == 0) {
      float m = warp_best[it & 1][0];
#pragma unroll
      for (int w = 1; w < kVmagThreads / kWarp; ++w) m = fmaxf(m, warp_best[it & 1][w]);
      if (parts == 1)
        out[u] = logf(fmaxf(sqrtf(m), 1e-20f));
      else
        cg::this_cluster().map_shared_rank(&part_best[it & 1][0], 0)[rank] = m;
    }
    if (parts > 1) {
      cg::this_cluster().sync();
      if (rank == 0 && threadIdx.x == 0) {
        float m = part_best[it & 1][0];
        for (int k = 1; k < parts; ++k) m = fmaxf(m, part_best[it & 1][k]);
        out[u] = logf(fmaxf(sqrtf(m), 1e-20f));
      }
    }
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

// CTAs of vmag_kernel<T, VEC, CPT> the card holds at once, and its SM
// count (queried once a process).
template <typename T, int VEC, int CPT>
void vmag_grid_info(int& cap, int& sms) {
  static int cap_ = 0, sms_ = 0;
  if (cap_ == 0) {
    int dev = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms_, cudaDevAttrMultiProcessorCount, dev);
    if (sms_ <= 0) sms_ = 132;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vmag_kernel<T, VEC, CPT>,
                                                  kVmagThreads, 0);
    cap_ = sms_ * (per_sm > 0 ? per_sm : 1);
  }
  cap = cap_;
  sms = sms_;
}

// One CTA a unit where the units fill the SMs; where they do not (the
// serving lanes' chunks: 64 blocks of a 1024-token chunk), clusters of 2
// or 4 CTAs split each block's rows, so the call spreads over the card in
// one launch.
template <typename T, int VEC, int CPT>
int launch_vmag(const void* v, float* out, long long units, int d, int bs, int lpr,
                cudaStream_t stream) {
  int cap = 0, sms = 0;
  vmag_grid_info<T, VEC, CPT>(cap, sms);
  int parts = 1;
  while (parts < kVmagMaxParts && units * parts < sms && bs % (2 * parts) == 0) parts *= 2;
  const long long clusters = units < cap / parts ? units : cap / parts;
  const T* vp = (const T*)v;
  if (parts == 1) {
    vmag_kernel<T, VEC, CPT><<<(int)clusters, kVmagThreads, 0, stream>>>(vp, out, units, d,
                                                                         bs, lpr, 1);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * parts));
  cfg.blockDim = dim3(kVmagThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, vmag_kernel<T, VEC, CPT>, vp, out, units, d, bs, lpr,
                                 parts);
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

// v (bh, n, d) contiguous -> out (bh, n/bs) float32, bs dividing n.  vec:
// elements a thread loads at once, 16 / sizeof(element) (v 16-byte
// aligned, a row a power-of-two number of 16-byte strips, at most 64) or 1
// (scalar loads, any alignment and d).
int stem_value_magnitude(const void* v, float* out, int bh, int n, int d, int bs,
                         int is_bf16, int vec, void* stream) {
  if (bs <= 0 || n % bs != 0 || bh <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long units = (long long)bh * (n / bs);
  if (vec == 1) {
    if (is_bf16) return launch_vmag<__nv_bfloat16, 1, 0>(v, out, units, d, bs, kWarp, st);
    return launch_vmag<float, 1, 0>(v, out, units, d, bs, kWarp, st);
  }
  const int want = is_bf16 ? 8 : 4, spr = d / want;
  if (vec != want || d % want != 0 || (uintptr_t)v % 16 != 0 || spr > 2 * kWarp ||
      (spr & (spr - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int lpr = spr < kWarp ? spr : kWarp;
  if (is_bf16)
    return spr > kWarp ? launch_vmag<__nv_bfloat16, 8, 2>(v, out, units, d, bs, lpr, st)
                       : launch_vmag<__nv_bfloat16, 8, 1>(v, out, units, d, bs, lpr, st);
  return spr > kWarp ? launch_vmag<float, 4, 2>(v, out, units, d, bs, lpr, st)
                     : launch_vmag<float, 4, 1>(v, out, units, d, bs, lpr, st);
}

}  // extern "C"
