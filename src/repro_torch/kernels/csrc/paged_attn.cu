// Paged Stem attention kernels for Hopper (sm_90a): summary-resident page
// scoring and flash-style attention over selected pages.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface (no PyTorch headers), loaded with ctypes.  Each
// entry point launches on the caller's stream, allocates nothing (the
// decode lane's split partials go to a workspace the wrapper allocates),
// and returns cudaGetLastError() of its launches.  The Python wrappers in
// repro_torch/kernels/paged_attn.py check device, dtype, shape, contiguity
// and alignment before calling in, and hold the plain PyTorch versions
// these kernels are tested against.
//
// stem_paged_score   replaces _score_kernel  (src/repro/kernels/paged_attn.py:142)
// stem_paged_attend  replaces _attend_kernel (src/repro/kernels/paged_attn.py:249)
//
// Bounds on the H100 and what the design does about them:
//  * Scoring reads every visible page's kg summary tile (stride x d fp32,
//    8 KiB at s = 16, d = 128) once and does 2 * s * d flops per (query
//    head, chunk row) against it: bytes-bound (phase 3's decode lane: 33 MB,
//    0.0099 ms at 3.35 TB/s; its chunk lane: 8.5 MB, 0.0028 ms).  At d = 128
//    and s 8, 16 or 32 two kernels, chosen by the query's stride over s;
//    every other shape one general kernel.  fp32 on the CUDA cores
//    (TF32 would break the 1e-4 parity), page ids read from the page table
//    in global memory, a page id outside [0, P) writing NaN in exactly its
//    column.
//      - score_bcast_kernel (the query broadcast over s: the decode lane, and
//        the chunk lane's mean pooling): the score is q . sum_u kg[u], so
//        one warp owns a page, reads its tile with 16-byte loads (all s rows
//        of a lane's 4 columns in flight at once), sums it over u in
//        registers and takes the g * nc dot products against it (s times
//        fewer FMAs than the contraction).  4 pages a CTA, grid
//        (ceil(maxp / 4), hk, b): at phase 3's decode shape 4032 warps, one
//        wave, every page in flight.
//      - score_kernel (the chunk lane): out(rows, pages) = Q (rows, s*d) .
//        KG(pages, s*d)^T per KV head, rows = its g heads x nc chunk rows.
//        The CTA's 256 threads split the s*d contraction, a 16-byte strip of
//        it per thread, and hold RT = 256 / s query rows of that strip in
//        registers for the CTA's life (128 floats; the rows tiled over
//        grid.y where g * nc > RT; the chunk lane's anti-diagonal pairing
//        u -> (s - u) mod s folded into the load).  Each kg tile goes
//        straight from global memory into the registers of the threads
//        that own its strips, the next page's strip loaded while this one
//        is scored (a thread uses only its own strip, so a shared-memory
//        ring would add a copy and share nothing), and feeds RT FMAs a
//        float.  A warp reduce-scatters its RT partial sums (RT - 1
//        shuffles, not RT warp sums), 8 pages' warp partials meet in shared
//        memory, one barrier pair a batch.  Pages per CTA are chosen from
//        the shape so the grid is about one CTA per SM (phase 3's chunk
//        shape: 8 pages, 128 CTAs).
//      - score_small_kernel (every other head_dim and stride, either query
//        layout: the small configurations, s * d = 32 at d 8, s 4): one
//        warp a page, its lanes splitting the page's s * d tile in 16-byte
//        loads, one warp sum a query row (the tile stays in L1 across the
//        rows).  Untimed: no timed configuration serves these shapes.
//  * Attention reads each selected K/V page and does 4*rows*bs*d flops
//    against it.
//      - decode (one query row per head): bytes-bound, and a row's pages
//        are few CTAs' worth of work, so it is split across the card
//        (flash-decoding).  attend_split_kernel's grid is (hq * nc,
//        splits, b), heads fastest; each CTA takes a contiguous range of
//        pages_per_split of its row's live slots in page order (it ranks
//        the slots by logical page itself), so the g heads of a KV head,
//        which select mostly the same pages, read them side by side and
//        the second read can come from L2.  It streams their K and V
//        through a 3-stage shared-memory ring of 16 KiB chunks, one
//        cp.async.bulk per operand completing on an mbarrier, issued by a
//        producer warp, so the next chunks are in flight while this one is
//        scored.  Eight consumer warps work as 16 half-warps: 16 lanes own
//        a key, each reading a 16-byte piece of its row, and reduce its dot
//        product in 4 shuffles (a row of fewer than 16 pieces, d < 128 in
//        bf16 or d < 64 in fp32, takes as many lanes as it has pieces, and
//        the key groups grow to match); each key group keeps its own online-softmax
//        state (m, l, acc) in registers, merged through shared memory at
//        the CTA's end into one fp32 partial.  A split past the row's live
//        count exits at once.  attend_combine_kernel rescales the row's
//        live partials by exp(m_s - m_max) and finalizes
//        acc / max(l, 1e-20).  fp32 math throughout (P is never rounded),
//        for fp32 and bf16 alike.
//      - chunk (block_size query rows): compute-bound.  bf16 at head_dim
//        and page size 128 runs on the tensor cores: attend_chunk_wgmma_kernel is the
//        one-shot prefill's TMA + wgmma tile (attn_wgmma.cuh) with the
//        page table in its producer: one CTA per (query head, chunk row,
//        batch row), heads fastest, each selected page one 128-key TMA
//        tile at row (kv_head * P + page) * 128 of the flattened pool,
//        pages above the tile's last query skipped, the causal mask at
//        absolute positions only on pages not wholly visible (the chunk
//        may start anywhere).  P is rounded to bf16 before P.V.  fp32 (and
//        bf16 at the other shapes) keep attend_tile_kernel on the fp32
//        CUDA cores: it stages each selected page's K and V in shared
//        memory (in halves where a page does not fit beside the tile's
//        state: d 256) and all warps stream the query rows against it,
//        keeping each row's online-softmax state in shared memory.
//    Every kernel is instantiated for head_dims 8, 16, 32, 64, 128 and 256
//    (any other is refused) and page sizes up to 128.
//    Page ids outside [0, P) are skipped; masked probabilities are exact
//    zeros, and a row with cnt == 0 finalizes 0 / 1e-20 = exact 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "attn_wgmma.cuh"
#include "head_dims.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarp = 32;
constexpr int kThreads = 256;          // 8 warps per CTA
constexpr int kMaxKeyTiles = 4;        // block_size <= 128 = 4 * 32
constexpr size_t kMaxSmemBytes = 232448; // dynamic shared memory a block may use

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
// Page scoring: out[b, h, c, p] = scale * sum_{u, k} qp[b, h, c, pair(u), k] *
//                                 kg[h / g, page_table[b, p], u, k]
// qp is addressed through strides (sb, sh, sc, ss) with head_dim contiguous
// and every stride a multiple of 4 floats; pair(u) = (s - u) mod s when
// `pair`, else u.  score_bcast_kernel and score_kernel take d = 128 with s a
// template argument (8, 16 or 32); score_small_kernel takes every other
// head_dim and stride.
// ---------------------------------------------------------------------------
constexpr int kScoreD = 128;
constexpr int kBcastWarps = 4;          // pages (one a warp) per score_bcast CTA
constexpr int kScoreThreads = 256;      // score_kernel: threads splitting s * d
constexpr int kScoreBatch = 8;          // pages whose warp partials meet in smem

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

__device__ __forceinline__ bool page_ok(int page, int num_pages) {
  return page >= 0 && page < num_pages;
}

__device__ __forceinline__ float score_nan() { return __int_as_float(0x7fc00000); }

// The query broadcast over s (ss == 0).  grid (ceil(maxp / 4), hk, b); warp
// w scores page blockIdx.x * 4 + w against the g * nc query rows of KV head
// blockIdx.y.  Lane l owns columns 4l .. 4l + 3.
template <int S>
__global__ void __launch_bounds__(kBcastWarps * kWarp)
score_bcast_kernel(const float* __restrict__ qp, long long sb, long long sh,
                   long long sc, const float* __restrict__ kg,
                   const int* __restrict__ page_table, float* __restrict__ out,
                   int hq, int hk, int nc, int maxp, int num_pages, float scale) {
  constexpr int kChunk = S < 16 ? S : 16;   // rows of the tile in flight at once
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int p = blockIdx.x * kBcastWarps + warp;
  if (p >= maxp) return;
  const int b = blockIdx.z, kvh = blockIdx.y, g = hq / hk;
  const int page = page_table[(long long)b * maxp + p];
  float* dst = out + (long long)b * hq * nc * maxp + p;
  if (!page_ok(page, num_pages)) {
    for (int o = lane; o < g * nc; o += kWarp)
      dst[((long long)kvh * g * nc + o) * maxp] = score_nan();
    return;
  }
  const float* tile = kg + ((long long)kvh * num_pages + page) * S * kScoreD + 4 * lane;
  float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int u0 = 0; u0 < S; u0 += kChunk) {
    float4 t[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) t[u] = ld4(tile + (u0 + u) * kScoreD);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      cs.x += t[u].x;
      cs.y += t[u].y;
      cs.z += t[u].z;
      cs.w += t[u].w;
    }
  }
  const float* qb = qp + b * sb + 4 * lane;
  for (int o = 0; o < g * nc; ++o) {
    const int gi = o / nc, ci = o - gi * nc;
    const float dot = warp_sum(dot4(ld4(qb + (kvh * g + gi) * sh + ci * sc), cs, 0.f));
    if (lane == 0) dst[((long long)kvh * g * nc + o) * maxp] = dot * scale;
  }
}

// v[N] holds a lane's partial sums of N rows (N a power of two <= 32).
// Afterwards v[0] holds the warp's full sum of row reduce_row<N>(lane), and
// the 32 / N lanes that share a row hold the same value.  Each step trades
// half of the rows a lane holds with the lane `off` away (N - 1 shuffles in
// all, not N warp sums), then 5 - log2(N) more finish the sums.
template <int N, int HALF>
struct ReduceScatter {
  __device__ __forceinline__ static void run(float (&v)[N], int lane, int off) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = upper ? v[i] : v[i + HALF];
      const float keep = upper ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    ReduceScatter<N, HALF / 2>::run(v, lane, off >> 1);
  }
};
template <int N>
struct ReduceScatter<N, 0> {
  __device__ __forceinline__ static void run(float (&v)[N], int, int off) {
#pragma unroll
    for (; off > 0; off >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  }
};

template <int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  ReduceScatter<N, N / 2>::run(v, lane, 16);
}

// The row whose sum reduce_scatter<N> leaves on `lane`.
template <int N>
__device__ __forceinline__ int reduce_row(int lane) {
  int row = 0;
#pragma unroll
  for (int off = 16, half = N / 2; half > 0; off >>= 1, half >>= 1)
    if (lane & off) row += half;
  return row;
}

// A thread's F strips of page `page`'s kg tile (zeros for a bad id): float4
// tid + 256 f of the tile, `tiles` already offset to the KV head and 4 tid.
template <int S, int F>
__device__ __forceinline__ void load_strips(const float* tiles, int page, int num_pages,
                                            float4 (&t)[F]) {
  const bool ok = page_ok(page, num_pages);
  const float* src = tiles + (long long)(ok ? page : 0) * S * kScoreD;
#pragma unroll
  for (int f = 0; f < F; ++f)
    t[f] = ok ? ld4(src + 4 * kScoreThreads * f) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// grid (ceil(maxp / pages_per_cta), hk * row_tiles, b).  CTA (x, y, b)
// scores pages [x * ppc, (x + 1) * ppc) against rows [tile * RT, tile * RT
// + RT) of KV head kvh (y = tile * hk + kvh), row r = gi * nc + ci.
template <int S>
__global__ void __launch_bounds__(kScoreThreads, 1)
score_kernel(const float* __restrict__ qp, long long sb, long long sh,
             long long sc, long long ss, int pair, const float* __restrict__ kg,
             const int* __restrict__ page_table, float* __restrict__ out,
             int hq, int hk, int nc, int maxp, int num_pages, int ppc, float scale) {
  constexpr int F = S * kScoreD / 4 / kScoreThreads;   // float4 strips a thread
  constexpr int RT = 32 / F;                           // query rows a CTA
  constexpr int kWarps = kScoreThreads / kWarp;
  __shared__ float part[kScoreBatch][kWarps][RT];
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int b = blockIdx.z, kvh = blockIdx.y % hk, tile = blockIdx.y / hk;
  const int g = hq / hk, rows = g * nc, r0 = tile * RT;
  const int p_begin = blockIdx.x * ppc, p_end = min(maxp, p_begin + ppc);
  const int* pt = page_table + (long long)b * maxp;

  // This thread's strips of the contraction: float4 j = tid + 256 f, i.e.
  // row u = j / 32 of the tile, columns 4 (j % 32) ...
  float4 q[RT][F];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = r0 + r;
    const int gi = row / nc, ci = row - gi * nc;
    const float* qb = qp + b * sb + (long long)(kvh * g + gi) * sh + ci * sc;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int j = tid + kScoreThreads * f, u = j / (kScoreD / 4);
      const int uq = pair ? (S - u) % S : u;
      q[r][f] = row < rows ? ld4(qb + uq * ss + 4 * (j % (kScoreD / 4)))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  const float* kv_tiles = kg + (long long)kvh * num_pages * S * kScoreD + 4 * tid;
  float4 cur[F], nxt[F];
  if (p_begin < p_end) load_strips<S, F>(kv_tiles, pt[p_begin], num_pages, cur);
  for (int p = p_begin; p < p_end; ++p) {
    if (p + 1 < p_end) load_strips<S, F>(kv_tiles, pt[p + 1], num_pages, nxt);
    float v[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) acc = dot4(q[r][f], cur[f], acc);
      v[r] = acc;
    }
    reduce_scatter<RT>(v, lane);
    const int i = (p - p_begin) % kScoreBatch;
    if ((lane & (32 / RT - 1)) == 0) part[i][warp][reduce_row<RT>(lane)] = v[0];
#pragma unroll
    for (int f = 0; f < F; ++f) cur[f] = nxt[f];
    if (i == kScoreBatch - 1 || p + 1 == p_end) {
      __syncthreads();
      const int pb = p - i;
      for (int o = tid; o < (i + 1) * RT; o += kScoreThreads) {
        const int pi = o / RT, r = o - pi * RT, row = r0 + r;
        if (row >= rows) continue;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += part[pi][w][r];
        const int gi = row / nc, ci = row - gi * nc;
        out[(((long long)b * hq + kvh * g + gi) * nc + ci) * maxp + pb + pi] =
            page_ok(pt[pb + pi], num_pages) ? sum * scale : score_nan();
      }
      __syncthreads();
    }
  }
}

// CTAs of score_kernel<S> the card holds at once (queried once a process).
template <int S>
int score_ctas() {
  static int cap = 0;
  if (cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, score_kernel<S>,
                                                  kScoreThreads, 0);
    cap = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  }
  return cap;
}

template <int S>
int launch_score(const float* qp, long long sb, long long sh, long long sc,
                 long long ss, int pair, const float* kg, const int* page_table,
                 float* out, int b, int hq, int hk, int nc, int maxp, int num_pages,
                 float scale, cudaStream_t stream) {
  if (ss == 0) {
    const dim3 grid((maxp + kBcastWarps - 1) / kBcastWarps, hk, b);
    score_bcast_kernel<S><<<grid, kBcastWarps * kWarp, 0, stream>>>(
        qp, sb, sh, sc, kg, page_table, out, hq, hk, nc, maxp, num_pages, scale);
    return (int)cudaGetLastError();
  }
  constexpr int RT = 32 / (S * kScoreD / 4 / kScoreThreads);
  const int tiles = (hq / hk * nc + RT - 1) / RT;
  // pages a CTA: the (b, KV head, row tile, page) work over one wave
  const long long units = (long long)b * hk * tiles;
  const long long cap = score_ctas<S>();
  const int ppc = (int)((units * maxp + cap - 1) / cap);
  const dim3 grid((maxp + ppc - 1) / ppc, hk * tiles, b);
  score_kernel<S><<<grid, kScoreThreads, 0, stream>>>(
      qp, sb, sh, sc, ss, pair, kg, page_table, out, hq, hk, nc, maxp, num_pages,
      ppc, scale);
  return (int)cudaGetLastError();
}

// Every shape the two kernels above do not take (any stride, d != 128, the
// query broadcast or strided): grid (ceil(maxp / 4), hk, b); warp w scores
// page blockIdx.x * 4 + w against the g * nc query rows of KV head
// blockIdx.y, its lanes splitting the page's s * d / 4 float4s (lane l: l,
// l + 32, ...), one warp sum a row.  The kg tile stays in L1 across the
// rows; ss == 0 reads the broadcast row for every u.
template <int D>
__global__ void __launch_bounds__(kBcastWarps * kWarp)
score_small_kernel(const float* __restrict__ qp, long long sb, long long sh,
                   long long sc, long long ss, int pair, const float* __restrict__ kg,
                   const int* __restrict__ page_table, float* __restrict__ out,
                   int hq, int hk, int nc, int maxp, int num_pages, int s, float scale) {
  constexpr int NC4 = D / 4;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int p = blockIdx.x * kBcastWarps + warp;
  if (p >= maxp) return;
  const int b = blockIdx.z, kvh = blockIdx.y, g = hq / hk;
  const int page = page_table[(long long)b * maxp + p];
  float* dst = out + (long long)b * hq * nc * maxp + p;
  const bool ok = page_ok(page, num_pages);
  const float* tile = kg + ((long long)kvh * num_pages + (ok ? page : 0)) * s * D;
  const int n4 = s * NC4;
  for (int o = 0; o < g * nc; ++o) {
    const int gi = o / nc, ci = o - gi * nc;
    const float* qr = qp + b * sb + (kvh * g + gi) * sh + ci * sc;
    float dot = 0.f;
    if (ok) {
      for (int j = lane; j < n4; j += kWarp) {
        const int u = j / NC4, c4 = j - u * NC4;
        const int uq = pair ? (s - u) % s : u;
        dot = dot4(ld4(qr + uq * ss + 4 * c4), ld4(tile + 4 * j), dot);
      }
      dot = warp_sum(dot);
    }
    if (lane == 0) dst[((long long)kvh * g * nc + o) * maxp] = ok ? dot * scale : score_nan();
  }
}

template <int D>
int launch_small(const float* qp, long long sb, long long sh, long long sc,
                 long long ss, int pair, const float* kg, const int* page_table,
                 float* out, int b, int hq, int hk, int nc, int s, int maxp,
                 int num_pages, float scale, cudaStream_t stream) {
  const dim3 grid((maxp + kBcastWarps - 1) / kBcastWarps, hk, b);
  score_small_kernel<D><<<grid, kBcastWarps * kWarp, 0, stream>>>(
      qp, sb, sh, sc, ss, pair, kg, page_table, out, hq, hk, nc, maxp, num_pages, s,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Decode lane, split across the card: one query row per (head, chunk row),
// keeping tokens < pos[b].
// Layouts: q/out (b, hq, nc, 1, D); gp/idx (b, hq, nc, kmax); cnt
// (b, hq, nc); ws (b * hq * nc, splits, D + 2) fp32 partials (acc, m, l),
// m in log2 units.
// ---------------------------------------------------------------------------
constexpr int kSplitWarps = 8;                               // consumer warps
constexpr int kSplitThreads = (kSplitWarps + 1) * kWarp;     // + a producer warp
constexpr int kSplitStages = 3;
constexpr int kChunkBytes = 16384;                           // K (or V) of a stage
constexpr int kMaxSplitPages = 16;                           // pages_per_split <= this

// The split kernel's shape at head_dim D: a key row is PIECES 16-byte
// pieces; LK lanes own a key (16 at D = 128, fewer where the row is
// shorter), each holding NP pieces of it; the consumer warps form GROUPS
// key groups; a stage holds KC keys (at most a page of 128), a group takes
// KH of them.  At D = 128: 16 lanes a key, 16 groups, 32 (fp32) or 64
// (bf16) keys a stage.
template <typename T, int D>
struct SplitShape {
  static constexpr int V = 16 / sizeof(T);                   // values in a piece
  static constexpr int PIECES = D / V;
  static constexpr int LK = PIECES < 16 ? PIECES : 16;
  static constexpr int NP = PIECES / LK;
  static constexpr int GROUPS = kSplitWarps * kWarp / LK;
  static constexpr int KC0 = kChunkBytes / (D * (int)sizeof(T));
  static constexpr int KC = KC0 < 128 ? KC0 : 128;
  static constexpr int KH = KC / GROUPS > 0 ? KC / GROUPS : 1;
};

template <typename T, int D>
struct SplitSmem {
  static constexpr int G = SplitShape<T, D>::GROUPS;
  uint8_t k[kSplitStages][kChunkBytes];
  uint8_t v[kSplitStages][kChunkBytes];
  float acc[G][D];
  float m[G];
  float l[G];
  int slot[kMaxSplitPages];                                  // this split's slots
  uint64_t full[kSplitStages];
  uint64_t empty[kSplitStages];
};

// One bulk copy global -> shared of `bytes` (a multiple of 16; both
// addresses 16-byte aligned), completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(stem_wg::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(stem_wg::smem_u32(bar))
      : "memory");
}

// A 16-byte piece of a row as floats: 4 fp32 or 8 bf16 values.
__device__ __forceinline__ void load_piece(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load_piece(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// The key chunks of one split: each of its slots (slot[0 .. n)) whose page
// id lies in [0, P) gives its page's chunks of at most kc keys, up to the
// one holding the last token before `limit` (later keys are all masked).
// Yields the chunk's element offset within the KV head's pool, its first
// token and its key count.
struct DecodeChunks {
  const int* gp;
  const int* idx;
  const int* slot;
  int s, n, num_pages, bs, d, kc, limit, c;   // c: next key inside page gp[slot[s]]
  __device__ __forceinline__ bool next(long long& src, int& tok0, int& nk) {
    while (s < n) {
      const int page = gp[slot[s]];
      const int t0 = idx[slot[s]] * bs + c;
      if (page >= 0 && page < num_pages && c < bs && t0 < limit) {
        src = ((long long)page * bs + c) * d;
        tok0 = t0;
        nk = min(kc, bs - c);
        c += kc;
        return true;
      }
      ++s;
      c = 0;
    }
    return false;
  }
};

// grid (hq * nc, splits, b), heads fastest; split y takes the live slots of
// ranks [y * pps, (y + 1) * pps) in page order (logical id, then slot), so
// the g heads of a KV head, which select mostly the same pages, read them
// side by side and the second read can come from L2.  A split past the
// row's live count exits at once and writes nothing.  Dynamic smem
// sizeof(SplitSmem<T, D>).
template <typename T, int D>
__global__ void __launch_bounds__(kSplitThreads, 2)
attend_split_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const int* __restrict__ gp,
                    const int* __restrict__ idx, const int* __restrict__ cnt,
                    const int* __restrict__ pos, float* __restrict__ ws, int hq,
                    int hk, int nc, int kmax, int bs, int num_pages, int pps,
                    float scale) {
  using Sh = SplitShape<T, D>;
  constexpr int V = Sh::V, LK = Sh::LK, NP = Sh::NP, G = Sh::GROUPS;
  constexpr int KC = Sh::KC, KH = Sh::KH;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  SplitSmem<T, D>& sm = *reinterpret_cast<SplitSmem<T, D>*>(smem_raw);
  const int h = blockIdx.x % hq, ci = blockIdx.x / hq, b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const long long row = ((long long)b * hq + h) * nc + ci;
  const int n = min(cnt[row], kmax);
  const int s0 = blockIdx.y * pps;
  if (s0 >= n) return;                               // the combine reads no partial
  const int limit = pos[b];
  const long long head = (long long)kvh * num_pages * bs * D;
  const int* gpr = gp + row * kmax;
  const int* idr = idx + row * kmax;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int key = idr[i];
    int r = 0;
    for (int j = 0; j < n; ++j) {
      const int kj = idr[j];
      r += kj < key || (kj == key && j < i);
    }
    if (r >= s0 && r < s0 + pps) sm.slot[r - s0] = i;
  }
  DecodeChunks chunks{gpr, idr, sm.slot, 0, min(pps, n - s0), num_pages, bs, D, KC, limit, 0};
  if (threadIdx.x == 0) {
    for (int st = 0; st < kSplitStages; ++st) {
      stem_wg::mbar_init(&sm.full[st], 1);
      stem_wg::mbar_init(&sm.empty[st], kSplitWarps * kWarp);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (warp == kSplitWarps) {
    // ---- producer warp: one lane issues every copy ----
    if (lane == 0) {
      long long src;
      int tok0, nk, it = 0;
      while (chunks.next(src, tok0, nk)) {
        const int st = it % kSplitStages;
        stem_wg::mbar_wait(&sm.empty[st], ((it / kSplitStages) & 1) ^ 1);
        const uint32_t bytes = nk * D * sizeof(T);
        stem_wg::mbar_expect_tx(&sm.full[st], 2 * bytes);
        bulk_load(sm.k[st], kpool + head + src, bytes, &sm.full[st]);
        bulk_load(sm.v[st], vpool + head + src, bytes, &sm.full[st]);
        ++it;
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: key group hw owns keys hw, hw + G, ... of a chunk;
    //      lane li the dims of pieces li, li + LK, ... (16-byte loads) ----
    const int hw = warp * (kWarp / LK) + lane / LK, li = lane % LK;
    const float qs = scale * 1.4426950408889634f;    // scores in log2 units
    float qr[NP * V], acc[NP * V];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float x[V];
      load_piece(q + row * D + (p * LK + li) * V, x);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        qr[p * V + e] = x[e] * qs;
        acc[p * V + e] = 0.f;
      }
    }
    float m = -INFINITY, l = 0.f;
    long long src;
    int tok0, nk, it = 0;
    while (chunks.next(src, tok0, nk)) {
      const int st = it % kSplitStages;
      stem_wg::mbar_wait(&sm.full[st], (it / kSplitStages) & 1);
      const T* ks = reinterpret_cast<const T*>(sm.k[st]);
      const T* vs = reinterpret_cast<const T*>(sm.v[st]);
      float sc[KH];
      float mx = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < KH; ++kk) {
        const int j = hw + kk * G;
        const T* krow = ks + min(j, nk - 1) * D;     // a short chunk re-reads its last key
        float dot = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          float x[V];
          load_piece(krow + (p * LK + li) * V, x);
#pragma unroll
          for (int e = 0; e < V; ++e) dot += qr[p * V + e] * x[e];
        }
#pragma unroll
        for (int o = LK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[kk] = (j < nk && tok0 + j < limit) ? dot : -INFINITY;
        mx = fmaxf(mx, sc[kk]);
      }
      // online softmax; a state that has seen no key (m = -inf) takes 0 in
      // place of m, so masked keys add exact zeros
      const float m_new = fmaxf(m, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m - m_use);
      l *= corr;
#pragma unroll
      for (int i = 0; i < NP * V; ++i) acc[i] *= corr;
#pragma unroll
      for (int kk = 0; kk < KH; ++kk) {
        const float pk = exp2f(sc[kk] - m_use);
        l += pk;
        const T* vrow = vs + min(hw + kk * G, nk - 1) * D;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          float x[V];
          load_piece(vrow + (p * LK + li) * V, x);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[p * V + e] += pk * x[e];
        }
      }
      m = m_new;
      stem_wg::mbar_arrive(&sm.empty[st]);
      ++it;
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int e = 0; e < V; ++e) sm.acc[hw][(p * LK + li) * V + e] = acc[p * V + e];
    if (li == 0) {
      sm.m[hw] = m;
      sm.l[hw] = l;
    }
  }
  __syncthreads();
  // merge the key groups' states into this split's partial
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float mm = -INFINITY;
#pragma unroll 16
    for (int i = 0; i < G; ++i) mm = fmaxf(mm, sm.m[i]);
    const float mu = mm == -INFINITY ? 0.f : mm;
    float ll = 0.f, a = 0.f;
#pragma unroll 16
    for (int i = 0; i < G; ++i) {
      const float f = exp2f(sm.m[i] - mu);
      ll += f * sm.l[i];
      a += f * sm.acc[i][d];
    }
    float* part = ws + (row * gridDim.y + blockIdx.y) * (D + 2);
    part[d] = a;
    if (d == 0) {
      part[D] = mm;
      part[D + 1] = ll;
    }
  }
}

// grid (b * hq * nc); D threads, one per head_dim column: merges the
// partials of a row's live splits (ceil(min(cnt, kmax) / pps) of them) and
// finalizes acc / max(l, 1e-20) (cnt == 0 rows: 0).
template <typename T, int D>
__global__ void __launch_bounds__(D)
attend_combine_kernel(const float* __restrict__ ws, const int* __restrict__ cnt,
                      T* __restrict__ out, int kmax, int splits, int pps) {
  const long long row = blockIdx.x;
  const int live = (min(cnt[row], kmax) + pps - 1) / pps;
  const int d = threadIdx.x;
  const float* w = ws + row * splits * (D + 2);
  float mm = -INFINITY;
  for (int s = 0; s < live; ++s) mm = fmaxf(mm, w[s * (D + 2) + D]);
  const float mu = mm == -INFINITY ? 0.f : mm;
  float ll = 0.f, a = 0.f;
  for (int s = 0; s < live; ++s) {
    const float f = exp2f(w[s * (D + 2) + D] - mu);  // 0 for a split that saw no key
    ll += f * w[s * (D + 2) + D + 1];
    a += f * w[s * (D + 2) + d];
  }
  out[row * D + d] = from_f32<T>(a / fmaxf(ll, 1e-20f));
}

// ---------------------------------------------------------------------------
// Chunk lane, bf16 at page size 128, on the tensor cores: the selected pages
// of one (query head, chunk row, batch row) as 128-key tiles of the shared
// TMA + wgmma tile.  Query row r of chunk row ci sits at token
// pos[b] + ci * 128 + r.
// ---------------------------------------------------------------------------
struct PagedTiles {
  const int* gp;
  const int* idx;
  int live, num_pages, q_tok0, s;
  __device__ __forceinline__ bool next(int& k0, int& off) {
    while (s < live) {
      const int page = gp[s], k_tok0 = idx[s] * stem_wg::kBN;
      ++s;
      if (page < 0 || page >= num_pages || k_tok0 > q_tok0 + stem_wg::kBM - 1) continue;
      k0 = page * stem_wg::kBN;
      off = k_tok0 - q_tok0;
      return true;
    }
    return false;
  }
};

__global__ void __launch_bounds__(stem_wg::kThreads, 1)
attend_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const int* __restrict__ gp, const int* __restrict__ idx,
                          const int* __restrict__ cnt, const int* __restrict__ pos,
                          __nv_bfloat16* __restrict__ out, int hq, int hk, int nc,
                          int kmax, int num_pages, float scale) {
  extern __shared__ uint8_t smem_wg[];
  const int h = blockIdx.x, ci = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hk);
  const long long row = ((long long)b * hq + h) * nc + ci;
  const long long q_row = row * stem_wg::kBM;
  const long long kv_row = (long long)kvh * num_pages * stem_wg::kBN;
  const PagedTiles sel{gp + row * kmax, idx + row * kmax, min(cnt[row], kmax), num_pages,
                       pos[b] + ci * stem_wg::kBM, 0};
  stem_wg::attend_tile(smem_wg, &tq, &tk, &tv, q_row, kv_row, sel, out + q_row * stem_wg::kD,
                       stem_wg::kBM, scale);
}

// ---------------------------------------------------------------------------
// Chunk lane on the fp32 CUDA cores (fp32, and bf16 off the tensor-core
// tile's shape: head_dim != 128 or page size != 128): a tile of `rows`
// query rows per (head, chunk row), causal at absolute positions.  grid
// (nc, hk, b).  A page's keys are staged kc at a time (kc = bs unless the
// page's K and V would not fit beside the tile's state: head_dim 256).
// Dynamic smem (floats): K kc*(D+1) | V kc*D | acc rows*D | m,l rows*2 |
//                        q nw*D | p nw*kc.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attend_tile_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                   const T* __restrict__ vpool, const int* __restrict__ gp,
                   const int* __restrict__ idx, const int* __restrict__ cnt,
                   const int* __restrict__ pos, T* __restrict__ out, int hq,
                   int hk, int nc, int rows, int kmax, int bs, int kc, int num_pages,
                   float scale) {
  constexpr int C = (D + kWarp - 1) / kWarp;   // output columns a lane
  constexpr int KS = D + 1;                // padded K row: conflict-free reads
  extern __shared__ float smem[];
  const int nw = blockDim.x / kWarp;
  float* k_s = smem;
  float* v_s = k_s + kc * KS;
  float* acc_s = v_s + kc * D;
  float* ml_s = acc_s + rows * D;
  float* q_s = ml_s + rows * 2;
  float* p_s = q_s + nw * D;
  const int ci = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = hq / hk;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* qw = q_s + warp * D;
  float* pw = p_s + warp * kc;

  for (int gi = 0; gi < g; ++gi) {
    const long long row = ((long long)b * hq + kvh * g + gi) * nc + ci;
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) acc_s[i] = 0.f;
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      ml_s[2 * r] = kNegInf;
      ml_s[2 * r + 1] = 0.f;
    }
    const int n = min(cnt[row], kmax);
    for (int sl = 0; sl < n; ++sl) {
      // an out-of-range id reads page 0 with every key masked, so every
      // thread meets the same barriers
      const int page = gp[row * kmax + sl];
      const bool ok = page >= 0 && page < num_pages;
      const long long base = ((long long)kvh * num_pages + (ok ? page : 0)) * bs * D;
      const int tok_page = ok ? idx[row * kmax + sl] * bs : INT_MAX / 2;
      for (int c0 = 0; c0 < bs; c0 += kc) {
        const int nk = min(kc, bs - c0), tok0 = tok_page + c0;
        __syncthreads();                     // previous keys fully consumed
        for (int i = threadIdx.x; i < nk * D; i += blockDim.x) {
          const int j = i / D, c = i - j * D;
          k_s[j * KS + c] = to_f32(kpool[base + c0 * D + i]);
          v_s[i] = to_f32(vpool[base + c0 * D + i]);
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
            keep[t] = j < nk && tok0 + j < limit;
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
            if (j < nk) pw[j] = p;
            ps += p;
          }
          ps = warp_sum(ps);
          __syncwarp();
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int col = lane + kWarp * c;
            if (D % kWarp != 0 && col >= D) continue;
            float a = acc_s[r * D + col] * corr;
            for (int j = 0; j < nk; ++j) a += pw[j] * v_s[j * D + col];
            acc_s[r * D + col] = a;
          }
          if (lane == 0) {
            ml_s[2 * r] = m_new;
            ml_s[2 * r + 1] = l_old * corr + ps;
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
    for (int r = warp; r < rows; r += nw) {
      const float ll = fmaxf(ml_s[2 * r + 1], 1e-20f);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + kWarp * c;
        if (D % kWarp != 0 && col >= D) continue;
        out[(row * rows + r) * D + col] = from_f32<T>(acc_s[r * D + col] / ll);
      }
    }
    __syncthreads();
  }
}

size_t tile_smem_bytes(int d, int rows, int kc) {
  const int nw = kThreads / kWarp;
  return sizeof(float) * ((size_t)kc * (d + 1) + (size_t)kc * d + (size_t)rows * d +
                          (size_t)rows * 2 + (size_t)nw * d + (size_t)nw * kc);
}

// Keys of a page the CUDA-core chunk tile stages at once: the whole page
// where it fits in a CTA's shared memory, else the largest half that does.
int tile_keys(int d, int rows, int bs) {
  int kc = bs;
  while (kc % 2 == 0 && kc > 8 && tile_smem_bytes(d, rows, kc) > kMaxSmemBytes) kc /= 2;
  return kc;
}

// Splits of the decode lane's grid: a row's kmax slots in ranges of pps;
// 0 for a shape the split kernel does not take.
int decode_splits(int kmax, int pps) {
  if (pps <= 0 || pps > kMaxSplitPages || kmax < 0) return 0;
  return kmax == 0 ? 1 : (kmax + pps - 1) / pps;
}

struct AttendArgs {
  const void *q, *k, *v;
  const int *gp, *idx, *cnt, *pos;
  void* out;
  float* ws;
  int b, hq, hk, nc, rows, bs, kmax, num_pages, splits, pps;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_decode(const AttendArgs& a) {
  if (a.splits <= 0 || a.splits != decode_splits(a.kmax, a.pps))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(SplitSmem<T, D>);
  cudaError_t err = cudaFuncSetAttribute(
      attend_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attend_split_kernel<T, D><<<dim3(a.hq * a.nc, a.splits, a.b), kSplitThreads, smem,
                              a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.gp, a.idx, a.cnt, a.pos, a.ws, a.hq,
      a.hk, a.nc, a.kmax, a.bs, a.num_pages, a.pps, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attend_combine_kernel<T, D><<<a.b * a.hq * a.nc, D, 0, a.stream>>>(
      a.ws, a.cnt, (T*)a.out, a.kmax, a.splits, a.pps);
  return (int)cudaGetLastError();
}

int launch_chunk_wgmma(const AttendArgs& a) {
  CUtensorMap tq, tk, tv;
  const long long kv_rows = (long long)a.hk * a.num_pages * stem_wg::kBN;
  if (!stem_wg::make_map(&tq, a.q, (long long)a.b * a.hq * a.nc * stem_wg::kBM) ||
      !stem_wg::make_map(&tk, a.k, kv_rows) || !stem_wg::make_map(&tv, a.v, kv_rows))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = stem_wg::prepare(attend_chunk_wgmma_kernel);
  if (err != cudaSuccess) return (int)err;
  attend_chunk_wgmma_kernel<<<dim3(a.hq, a.nc, a.b), stem_wg::kThreads, stem_wg::kSmemBytes,
                              a.stream>>>(tq, tk, tv, a.gp, a.idx, a.cnt, a.pos,
                                          (__nv_bfloat16*)a.out, a.hq, a.hk, a.nc, a.kmax,
                                          a.num_pages, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_tile(const AttendArgs& a) {
  const int kc = tile_keys(D, a.rows, a.bs);
  const size_t smem = tile_smem_bytes(D, a.rows, kc);
  cudaError_t err = cudaFuncSetAttribute(
      attend_tile_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attend_tile_kernel<T, D><<<dim3(a.nc, a.hk, a.b), kThreads, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.gp, a.idx, a.cnt, a.pos, (T*)a.out,
      a.hq, a.hk, a.nc, a.rows, a.kmax, a.bs, kc, a.num_pages, a.scale);
  return (int)cudaGetLastError();
}

// One lane at head_dim D: rows == 1 the decode lane (split + combine), else
// the chunk lane (the tensor-core tile for bf16 at d = rows = bs = 128).
template <typename T, int D>
int launch_attend(const AttendArgs& a) {
  if (a.rows == 1) return launch_decode<T, D>(a);
  if constexpr (D == stem_wg::kD && sizeof(T) == 2) {
    if (a.rows == stem_wg::kBM && a.bs == stem_wg::kBN) return launch_chunk_wgmma(a);
  }
  return launch_tile<T, D>(a);
}

}  // namespace

extern "C" {

// The decode lane's split count for these shapes (the wrapper sizes its
// workspace by it); 0 if the split kernel does not take them.
int stem_paged_decode_splits(int kmax, int pps) { return decode_splits(kmax, pps); }

// Bytes of dynamic shared memory the CUDA-core chunk-lane kernel needs at
// these shapes (the wrapper refuses shapes above the card's 227 KiB
// per-block limit).
long long stem_paged_attend_tile_smem(int d, int rows, int bs) {
  return (long long)tile_smem_bytes(d, rows, tile_keys(d, rows, bs));
}

// qp (b, hq, nc, s, d) fp32 through strides (sb, sh, sc, ss), head_dim
// contiguous, 16-byte aligned, strides multiples of 4.  pair: read group
// (s - u) mod s of qp against group u of kg.  kg (hk, P, s, d) and
// page_table (b, maxp) contiguous; out (b, hq, nc, maxp).  d one of 8, 16,
// 32, 64, 128, 256; any s >= 1.  d = 128 with s 8, 16 or 32 runs
// score_bcast_kernel where ss == 0 (the query broadcast over s), else
// score_kernel; every other shape runs score_small_kernel.
int stem_paged_score(const float* qp, long long sb, long long sh, long long sc,
                     long long ss, int pair, const float* kg, const int* page_table,
                     float* out, int b, int hq, int hk, int nc, int s, int d,
                     int maxp, int num_pages, float scale, void* stream) {
  if (s <= 0 || hk <= 0 || hq % hk != 0 || maxp <= 0 || b <= 0 || nc <= 0 ||
      b > 65535 || (uintptr_t)qp % 16 != 0 || (sb | sh | sc | ss) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == kScoreD) {
    switch (s) {
      case 8:
        return launch_score<8>(qp, sb, sh, sc, ss, pair, kg, page_table, out, b, hq, hk,
                               nc, maxp, num_pages, scale, st);
      case 16:
        return launch_score<16>(qp, sb, sh, sc, ss, pair, kg, page_table, out, b, hq, hk,
                                nc, maxp, num_pages, scale, st);
      case 32:
        return launch_score<32>(qp, sb, sh, sc, ss, pair, kg, page_table, out, b, hq, hk,
                                nc, maxp, num_pages, scale, st);
      default:
        break;
    }
  }
  STEM_HEAD_DIM_SWITCH(d, launch_small<D>(qp, sb, sh, sc, ss, pair, kg, page_table, out, b,
                                          hq, hk, nc, s, maxp, num_pages, scale, st))
}

// is_bf16: 0 = float32 q/k/v/out, 1 = bfloat16.  rows == 1 runs the decode
// lane (length mask): the split kernel over `splits` ranges of `pps` slots
// each (splits from stem_paged_decode_splits) into workspace
// (b * hq * nc * splits * (d + 2) floats), then the combine kernel.  rows >
// 1 runs the causal chunk lane: the tensor-core tile for bf16 at d = rows
// == bs == 128 (q, k, v 16-byte aligned for TMA), else the CUDA-core tile.
// d one of 8, 16, 32, 64, 128, 256 and bs at most 128 (the wrapper checks
// both, and 16-byte alignment of every pointer the decode lane
// bulk-copies).
int stem_paged_attend(const void* q, const void* k, const void* v,
                      const int* gp, const int* idx, const int* cnt,
                      const int* pos, void* out, void* workspace, int b, int hq,
                      int hk, int nc, int rows, int d, int bs,
                      int kmax, int num_pages, int splits, int pps, int is_bf16,
                      float scale, void* stream) {
  if (bs > kMaxKeyTiles * kWarp || bs <= 0 || hk <= 0 || hq % hk != 0)
    return (int)cudaErrorInvalidValue;
  const AttendArgs a{q, k, v, gp, idx, cnt, pos, out, (float*)workspace, b, hq, hk, nc,
                     rows, bs, kmax, num_pages, splits, pps, scale, (cudaStream_t)stream};
  if (is_bf16) {
    STEM_HEAD_DIM_SWITCH(d, launch_attend<__nv_bfloat16, D>(a))
  }
  STEM_HEAD_DIM_SWITCH(d, launch_attend<float, D>(a))
}

}  // extern "C"
