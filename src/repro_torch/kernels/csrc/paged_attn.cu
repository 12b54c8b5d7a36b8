// Paged Stem attention kernels for Hopper (sm_90a): summary-resident page
// scoring and flash-style attention over selected pages.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface (no PyTorch headers), loaded with ctypes.  Each
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() of its launch.  The Python wrappers in
// repro_torch/kernels/paged_attn.py check device, dtype, shape and
// contiguity before calling in, and hold the plain PyTorch versions these
// kernels are tested against.
//
// stem_paged_score   replaces _score_kernel  (src/repro/kernels/paged_attn.py:142)
// stem_paged_attend  replaces _attend_kernel (src/repro/kernels/paged_attn.py:249)
//
// Bounds on the H100 and what the design does about them:
//  * Scoring reads every visible page's kg summary tile (stride x d fp32,
//    8 KiB at s=16, d=128) once and does 2*s*d flops per (query head,
//    chunk row) against it: bytes-bound.  One CTA owns (batch row, KV head,
//    8 candidate pages); it stages each page's kg tile in shared memory ONCE
//    and scores it against all g query heads of the KV head and all nc chunk
//    rows (the Pallas grid (b*hq, maxp) re-reads it g times).  The page id
//    comes from the page table in global memory; reductions are fp32.
//  * Attention reads each selected K/V page and does 4*rows*bs*d flops
//    against it.  The decode lane (one query row per head) is bytes-bound;
//    the chunk lane (block_size query rows) is compute-bound.  This first
//    version runs the products on the fp32 CUDA cores (no wgmma/TMA yet):
//      - decode: a CTA owns (batch row, KV head) with the g query heads of
//        the group; its warps split each head's selected pages (flash-
//        decoding inside the CTA, partial softmax states merged in shared
//        memory), reading K/V with lanes across head_dim so every load is
//        coalesced.  Heads of a group that selected the same page re-read
//        it from L1/L2, not HBM.
//      - chunk: a CTA owns (batch row, KV head, chunk row); for each query
//        head of the group it stages each selected page's K and V in shared
//        memory once (fp32, K padded to avoid bank conflicts) and all warps
//        stream the block_size query rows against it, keeping each row's
//        online-softmax state (m, l, acc) in shared memory.
//    Masked probabilities are zeroed explicitly (a fully masked first page
//    adds nothing), and a row with cnt == 0 finalizes 0 / 1e-20 = exact 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarp = 32;
constexpr int kThreads = 256;          // 8 warps per CTA
constexpr int kScorePages = 8;         // candidate pages per scoring CTA
constexpr int kMaxKeyTiles = 4;        // block_size <= 128 = 4 * 32

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Page scoring: out[b, h, c, p] = scale * sum_{u, k} qp[b, h, c, u, k] *
//                                 kg[h / g, page_table[b, p], u, k]
// grid (ceil(maxp / kScorePages), hk, b); dynamic smem s * d floats.
// qp is addressed through strides (sb, sh, sc, ss) with head_dim contiguous,
// so the decode lane passes its single query broadcast over s (ss = 0).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
score_kernel(const float* __restrict__ qp, long long sb, long long sh,
             long long sc, long long ss, const float* __restrict__ kg,
             const int* __restrict__ page_table, float* __restrict__ out,
             int hq, int hk, int nc, int s, int d, int maxp, int num_pages,
             float scale) {
  extern __shared__ float kg_s[];
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int g = hq / hk;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nw = blockDim.x / kWarp;
  const int sd = s * d;
  const int p_end = min(maxp, (blockIdx.x + 1) * kScorePages);
  for (int p = blockIdx.x * kScorePages; p < p_end; ++p) {
    const int page = page_table[(long long)b * maxp + p];
    const bool valid = page >= 0 && page < num_pages;
    __syncthreads();                       // previous tile fully consumed
    if (valid) {
      const float* src = kg + ((long long)kvh * num_pages + page) * sd;
      for (int i = threadIdx.x; i < sd; i += blockDim.x) kg_s[i] = src[i];
    }
    __syncthreads();
    for (int o = warp; o < g * nc; o += nw) {
      const int gi = o / nc, ci = o - gi * nc;
      const int h = kvh * g + gi;
      const float* qrow = qp + b * sb + h * sh + ci * sc;
      float acc = 0.f;
      for (int i = lane; i < sd; i += kWarp) {
        const int u = i / d;
        acc += qrow[u * ss + (i - u * d)] * kg_s[i];
      }
      acc = warp_sum(acc);
      if (lane == 0)
        out[(((long long)b * hq + h) * nc + ci) * maxp + p] =
            valid ? acc * scale : __int_as_float(0x7fc00000);   // NaN: bad page id
    }
  }
}

// ---------------------------------------------------------------------------
// Attention over selected pages, one query row per (head, chunk row):
// the decode lane, keeping tokens < pos[b].  grid (nc, hk, b); dynamic smem
// nw * (D + 2) floats.
// Layouts: q/out (b, hq, nc, 1, D); gp/idx (b, hq, nc, kmax); cnt (b, hq, nc).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attend_row_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                  const T* __restrict__ vpool, const int* __restrict__ gp,
                  const int* __restrict__ idx, const int* __restrict__ cnt,
                  const int* __restrict__ pos, T* __restrict__ out, int hq,
                  int hk, int nc, int kmax, int bs, int num_pages, float scale) {
  constexpr int C = D / kWarp;             // head_dim columns per lane
  extern __shared__ float part_s[];        // per warp: acc[D], m, l
  const int ci = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = hq / hk;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nw = blockDim.x / kWarp;
  const int limit = pos[b];                // tokens < limit kept
  float* part = part_s + warp * (D + 2);

  for (int gi = 0; gi < g; ++gi) {
    const long long row = ((long long)b * hq + kvh * g + gi) * nc + ci;
    float qr[C], acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      qr[c] = to_f32(q[row * D + lane + kWarp * c]) * scale;
      acc[c] = 0.f;
    }
    float m = kNegInf, l = 0.f;
    const int n = cnt[row];
    for (int sl = warp; sl < n; sl += nw) {
      const long long base =
          ((long long)kvh * num_pages + gp[row * kmax + sl]) * bs * D;
      const int tok0 = idx[row * kmax + sl] * bs;
      const T* kp = kpool + base;
      const T* vp = vpool + base;
      float sv[kMaxKeyTiles];
#pragma unroll
      for (int t = 0; t < kMaxKeyTiles; ++t) {
        sv[t] = kNegInf;
        for (int jj = 0; jj < kWarp; ++jj) {
          const int j = t * kWarp + jj;
          if (j >= bs) break;
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) dot += qr[c] * to_f32(kp[j * D + lane + kWarp * c]);
          dot = warp_sum(dot);
          if (lane == jj) sv[t] = dot;
        }
      }
      bool keep[kMaxKeyTiles];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kMaxKeyTiles; ++t) {
        const int j = t * kWarp + lane;
        keep[t] = j < bs && tok0 + j < limit;
        if (!keep[t]) sv[t] = kNegInf;
        mx = fmaxf(mx, sv[t]);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      float pr[kMaxKeyTiles], ps = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxKeyTiles; ++t) {
        pr[t] = keep[t] ? expf(sv[t] - m_new) : 0.f;
        ps += pr[t];
      }
      ps = warp_sum(ps);
      l = l * corr + ps;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] *= corr;
#pragma unroll
      for (int t = 0; t < kMaxKeyTiles; ++t) {
        for (int jj = 0; jj < kWarp; ++jj) {
          const int j = t * kWarp + jj;
          if (j >= bs) break;
          const float pj = __shfl_sync(0xffffffffu, pr[t], jj);
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += pj * to_f32(vp[j * D + lane + kWarp * c]);
        }
      }
      m = m_new;
    }
    // Merge the warps' partial softmax states for this head.
#pragma unroll
    for (int c = 0; c < C; ++c) part[lane + kWarp * c] = acc[c];
    if (lane == 0) {
      part[D] = m;
      part[D + 1] = l;
    }
    __syncthreads();
    if (warp == 0) {
      float mm = kNegInf;
      for (int w = 0; w < nw; ++w) mm = fmaxf(mm, part_s[w * (D + 2) + D]);
      float ll = 0.f, o[C];
#pragma unroll
      for (int c = 0; c < C; ++c) o[c] = 0.f;
      for (int w = 0; w < nw; ++w) {
        const float* pw = part_s + w * (D + 2);
        const float f = expf(pw[D] - mm);
        ll += pw[D + 1] * f;
#pragma unroll
        for (int c = 0; c < C; ++c) o[c] += pw[lane + kWarp * c] * f;
      }
      ll = fmaxf(ll, 1e-20f);
#pragma unroll
      for (int c = 0; c < C; ++c) out[row * D + lane + kWarp * c] = from_f32<T>(o[c] / ll);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Attention over selected pages for a tile of `rows` query rows per
// (head, chunk row): the chunk lane, causal at absolute positions (query
// row r of chunk row ci sits at pos[b] + ci * rows + r).  grid (nc, hk, b).
// Dynamic smem (floats): K bs*(D+1) | V bs*D | acc rows*D | m,l rows*2 |
//                        q nw*D | p nw*bs.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attend_tile_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                   const T* __restrict__ vpool, const int* __restrict__ gp,
                   const int* __restrict__ idx, const int* __restrict__ cnt,
                   const int* __restrict__ pos, T* __restrict__ out, int hq,
                   int hk, int nc, int rows, int kmax, int bs, int num_pages,
                   float scale) {
  constexpr int C = D / kWarp;
  constexpr int KS = D + 1;                // padded K row: conflict-free reads
  extern __shared__ float smem[];
  const int nw = blockDim.x / kWarp;
  float* k_s = smem;
  float* v_s = k_s + bs * KS;
  float* acc_s = v_s + bs * D;
  float* ml_s = acc_s + rows * D;
  float* q_s = ml_s + rows * 2;
  float* p_s = q_s + nw * D;
  const int ci = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = hq / hk;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* qw = q_s + warp * D;
  float* pw = p_s + warp * bs;

  for (int gi = 0; gi < g; ++gi) {
    const long long row = ((long long)b * hq + kvh * g + gi) * nc + ci;
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) acc_s[i] = 0.f;
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      ml_s[2 * r] = kNegInf;
      ml_s[2 * r + 1] = 0.f;
    }
    const int n = cnt[row];
    for (int sl = 0; sl < n; ++sl) {
      const long long base =
          ((long long)kvh * num_pages + gp[row * kmax + sl]) * bs * D;
      const int tok0 = idx[row * kmax + sl] * bs;
      __syncthreads();                     // previous page fully consumed
      for (int i = threadIdx.x; i < bs * D; i += blockDim.x) {
        const int j = i / D, c = i - j * D;
        k_s[j * KS + c] = to_f32(kpool[base + i]);
        v_s[i] = to_f32(vpool[base + i]);
      }
      __syncthreads();
      for (int r = warp; r < rows; r += nw) {
        const T* qsrc = q + (row * rows + r) * D;
        for (int c = lane; c < D; c += kWarp) qw[c] = to_f32(qsrc[c]) * scale;
        __syncwarp();
        const int limit = pos[b] + ci * rows + r + 1;
        float sv[kMaxKeyTiles];
        bool keep[kMaxKeyTiles];
        float mx = kNegInf;
#pragma unroll
        for (int t = 0; t < kMaxKeyTiles; ++t) {
          const int j = t * kWarp + lane;
          float dot = kNegInf;
          keep[t] = j < bs && tok0 + j < limit;
          if (keep[t]) {
            const float* krow = k_s + j * KS;
            dot = 0.f;
#pragma unroll 8
            for (int c = 0; c < D; ++c) dot += qw[c] * krow[c];
          }
          sv[t] = dot;
          mx = fmaxf(mx, dot);
        }
        mx = warp_max(mx);
        const float m_old = ml_s[2 * r], l_old = ml_s[2 * r + 1];
        const float m_new = fmaxf(m_old, mx);
        const float corr = expf(m_old - m_new);
        float ps = 0.f;
#pragma unroll
        for (int t = 0; t < kMaxKeyTiles; ++t) {
          const int j = t * kWarp + lane;
          const float p = keep[t] ? expf(sv[t] - m_new) : 0.f;
          if (j < bs) pw[j] = p;
          ps += p;
        }
        ps = warp_sum(ps);
        __syncwarp();
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = lane + kWarp * c;
          float a = acc_s[r * D + col] * corr;
          for (int j = 0; j < bs; ++j) a += pw[j] * v_s[j * D + col];
          acc_s[r * D + col] = a;
        }
        if (lane == 0) {
          ml_s[2 * r] = m_new;
          ml_s[2 * r + 1] = l_old * corr + ps;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int r = warp; r < rows; r += nw) {
      const float ll = fmaxf(ml_s[2 * r + 1], 1e-20f);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + kWarp * c;
        out[(row * rows + r) * D + col] = from_f32<T>(acc_s[r * D + col] / ll);
      }
    }
    __syncthreads();
  }
}

size_t tile_smem_bytes(int d, int rows, int bs) {
  const int nw = kThreads / kWarp;
  return sizeof(float) * ((size_t)bs * (d + 1) + (size_t)bs * d + (size_t)rows * d +
                          (size_t)rows * 2 + (size_t)nw * d + (size_t)nw * bs);
}

template <typename T, int D>
int launch_attend(const void* q, const void* k, const void* v, const int* gp,
                  const int* idx, const int* cnt, const int* pos, void* out,
                  int b, int hq, int hk, int nc, int rows, int bs, int kmax,
                  int num_pages, float scale, cudaStream_t stream) {
  const dim3 grid(nc, hk, b);
  if (rows == 1) {
    const size_t smem = sizeof(float) * (kThreads / kWarp) * (D + 2);
    attend_row_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, gp, idx, cnt, pos, (T*)out, hq,
        hk, nc, kmax, bs, num_pages, scale);
  } else {
    const size_t smem = tile_smem_bytes(D, rows, bs);
    cudaError_t err = cudaFuncSetAttribute(
        attend_tile_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attend_tile_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, gp, idx, cnt, pos, (T*)out, hq,
        hk, nc, rows, kmax, bs, num_pages, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the chunk-lane kernel needs (the wrapper
// refuses shapes above the card's 227 KiB per-block limit).
long long stem_paged_attend_tile_smem(int d, int rows, int bs) {
  return (long long)tile_smem_bytes(d, rows, bs);
}

int stem_paged_score(const float* qp, long long sb, long long sh, long long sc,
                     long long ss, const float* kg, const int* page_table,
                     float* out, int b, int hq, int hk, int nc, int s, int d,
                     int maxp, int num_pages, float scale, void* stream) {
  const dim3 grid((maxp + kScorePages - 1) / kScorePages, hk, b);
  const size_t smem = sizeof(float) * (size_t)s * d;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  score_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      qp, sb, sh, sc, ss, kg, page_table, out, hq, hk, nc, s, d, maxp,
      num_pages, scale);
  return (int)cudaGetLastError();
}

// is_bf16: 0 = float32 q/k/v/out, 1 = bfloat16.  rows == 1 runs the decode
// lane (length mask), rows > 1 the causal chunk lane.  d must be 128 and bs
// at most 128 (the wrapper checks both).
int stem_paged_attend(const void* q, const void* k, const void* v,
                      const int* gp, const int* idx, const int* cnt,
                      const int* pos, void* out, int b, int hq, int hk, int nc,
                      int rows, int d, int bs, int kmax, int num_pages,
                      int is_bf16, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bs > kMaxKeyTiles * kWarp || d != 128) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_attend<__nv_bfloat16, 128>(q, k, v, gp, idx, cnt, pos, out, b, hq, hk,
                                             nc, rows, bs, kmax, num_pages, scale, st);
  return launch_attend<float, 128>(q, k, v, gp, idx, cnt, pos, out, b, hq, hk, nc, rows,
                                   bs, kmax, num_pages, scale, st);
}

}  // extern "C"
