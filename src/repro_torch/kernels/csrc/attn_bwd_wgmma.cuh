// Shared device code of the bf16 attention backward kernels on Hopper's
// tensor cores (flash_attention.cu, block_sparse_attn.cu): the route the
// wrappers' backward_route names "wgmma", the forward's table (bf16 at the
// (q/k, v) pairs of head_dims.cuh STEM_WGMMA_PAIR_SWITCH, a block-sparse
// block that is a multiple of 128).  Every other shape runs attn_bwd.cuh's
// CUDA-core tiles.
//
// With S = scale * Q.K^T, P = exp(S - lse), dP = dO.V^T, delta = rowsum(dO
// * O) and dS = P * (dP - delta):  dQ = scale * dS.K,  dK = scale * dS^T.Q,
// dV = P^T.dO.  lse is the forward's: its kernels save each row's
// natural-log log-sum-exp (+inf for a row that saw no key, so P = 0).
// Two kernels, no atomics (a fixed summation order, bitwise run to run),
// each a template over its shape (BwdOf<D, DV> below):
//
//   dq_tile    one CTA per 128 query rows of a (batch, query head), the
//              forward's attend_tile with a second operand: Q and dO
//              resident, K and V streamed by TMA through a ring of BN-key
//              stages.  Per key tile each consumer warpgroup (64 rows)
//              issues S = Q.K^T and dP = dO.V^T (m64nBNk16, both operands
//              K-major), forms P and dS in registers while dP is in flight,
//              rounds dS to bf16 as the register A operand of dQ += dS.K
//              (m64nDk16, K read MN-major through the transpose bit, as the
//              forward reads V).  delta is computed in the prologue from O
//              and dO and written for the second kernel.
//   dkdv_tile  one CTA per BK keys of a (batch, KV head): K and V resident,
//              Q and dO streamed as 64-query tiles through a ring with each
//              tile's lse and delta (loaded by the producer's first warp
//              into the stage).  The CTA walks the query heads of its KV
//              head and their query tiles in a fixed order.  Two layouts:
//     paired   (BK 128, D + DV <= 256) each consumer warpgroup owns 64 keys
//              and all of their work: S^T = K.Q^T and dP^T = V.dO^T
//              (m64n64k16), P^T and dS^T in registers rounded to bf16, dV
//              += P^T.dO and dK += dS^T.Q (m64nDVk16 / m64nDk16, A from
//              registers, B MN-major).  A thread holds dK D / 2 + dV DV / 2
//              + S^T 32 + dP^T 32 floats and 32 fragment registers: 224 at
//              (128, 128), under the consumers' 232.
//     split    (BK 64, D + DV > 256, where dK and dV of 64 keys alone take
//              160-256 registers a thread) the two warpgroups share the
//              same 64 keys: warpgroup 0 computes S^T, P^T and holds dK,
//              warpgroup 1 dP^T, dS^T and holds dV.  P^T (fp32) and dS^T
//              (bf16 A fragments) cross through shared memory in the
//              accumulator's own thread layout (the two warpgroups' m64n64
//              accumulators are laid out alike), behind two mbarriers of
//              128 arrivals: P ready (0 -> 1), dS ready (1 -> 0).
//              Warpgroup 0 then issues dK += dS^T.Q, warpgroup 1 dV +=
//              P^T.dO, side by side.  The
//              arithmetic is the paired layout's: P in fp32, dS = P * (dP -
//              delta) in fp32, both rounded to bf16 before their products.
//
// Shapes (BwdOf; shared memory of 227 KiB; consumer registers: dq D / 2 +
// BN + BN / 4, dk/dv as above):
//   (64, 64)    dq BN 128 x 4 stages: Q 16 + dO 16 + 4 x (16 + 16) = 160 KiB, 192 regs
//               dkdv paired, 4 stages: K 16 + V 16 + 4 x (8 + 8) = 96 KiB, 160 regs
//   (128, 128)  dq BN 128 x 2: 32 + 32 + 2 x (32 + 32) = 192 KiB, 224 regs
//               dkdv paired, 3: 32 + 32 + 3 x (16 + 16) = 160 KiB, 224 regs
//   (192, 128)  dq BN 64 x 3: 48 + 32 + 3 x (24 + 16) = 200 KiB, 176 regs
//               dkdv split, 3: 24 + 16 + 3 x (24 + 16) + 24 = 184 KiB,
//               dK 96 + S 32 + dS 16 / dV 64 + dP 32 + P 16 + dS 16
//   (192, 192)  dq BN 64 x 2: 48 + 48 + 2 x (24 + 24) = 192 KiB, 176 regs
//               dkdv split, 3: 24 + 24 + 3 x (24 + 24) + 24 = 216 KiB, 144 / 160
//   (256, 256)  dq BN 32 x 3: 64 + 64 + 3 x (16 + 16) = 224 KiB, 168 regs
//               dkdv split, 2: 32 + 32 + 2 x (32 + 32) + 24 = 216 KiB, 176 / 192
// (the split layout's 24 KiB: P^T 16 + dS^T 8 exchanged).
//
// Few KV heads (gemma-2b's one at b 1: 64 dk/dv CTAs on 132 SMs, the first
// walking 8 heads x 64 query tiles): head_split spreads the g query heads
// of a KV head over S CTAs, each summing its g / S heads into an fp32
// partial of dK and dV (unscaled), and reduce_kv_partials then sums the S
// partials in order (s = 0..S-1) into dk and dv: no atomics, and bitwise
// run to run.  S = 1 (no partials, no third launch) wherever the grid
// already holds 1.5 waves.
//
// P and dS are rounded to bf16 before their products (as SDPA's backward
// does); the plain version keeps them in fp32, hence the p_bf16 rule.
// Bound: 2 * (3 d + 2 dv) flops a causal pair (S, dP, dV, dK, dQ) on 989
// TFLOP/s bf16; the split without atomics recomputes S and dP in both
// kernels, 7 products a pair.  Layouts are attn_wgmma.cuh's: 128-byte
// swizzled 64-column boxes of 128, 64 or 32 rows.  Both kernels take the
// forward's grid order (stem_wg::tiles_fastest): when the streamed operand
// of every head exceeds twice the L2 (deepseek-v3-671b's 128 heads), one
// head's tiles run side by side so that each streamed tile is read from
// memory once for all of them.
#pragma once

#include <algorithm>

#include "attn_wgmma.cuh"

namespace stem_bwg {

namespace wg = stem_wg;

constexpr int kQT = 64;                       // query rows of a dk/dv stage
constexpr float kLog2e = 1.4426950408889634f;

// The dq kernel at q/k head_dim D, v head_dim DV, BN keys a stage and a
// ring of STAGES stages.
template <int D_, int DV_, int BN_, int STAGES_>
struct DqShape {
  static constexpr int D = D_, DV = DV_, BN = BN_, kStages = STAGES_;
  static_assert(D % 64 == 0 && DV % 64 == 0 && D <= 256 && DV <= 256 &&
                    (BN == 32 || BN == 64 || BN == 128),
                "64-column boxes, n <= 256 wgmma, 32- / 64- / 128-key stages");
  static constexpr int kQBox = wg::kBM * 128;   // one 64-column box of 128 rows
  static constexpr int kKVBox = BN * 128;       // of BN rows
  static constexpr int kQBytes = D / 64 * kQBox, kDoBytes = DV / 64 * kQBox;
  static constexpr int kKBytes = D / 64 * kKVBox, kVBytes = DV / 64 * kKVBox;
  struct Smem {
    uint8_t q[kQBytes];
    uint8_t dout[kDoBytes];
    uint8_t k[kStages][kKBytes];
    uint8_t v[kStages][kVBytes];
    uint64_t full_k[kStages];
    uint64_t full_v[kStages];
    uint64_t empty[kStages];
    uint64_t q_full;
  };
  static constexpr size_t kSmemBytes = sizeof(Smem) + 1024;   // + room to align the base
  static_assert(kSmemBytes <= wg::kMaxSmemBytes, "the dq ring does not fit");
};

// The dk/dv kernel at (D, DV), BK keys a CTA (128: paired, 64: split) and a
// ring of STAGES 64-query stages.
template <int D_, int DV_, int BK_, int STAGES_>
struct DkdvShape {
  static constexpr int D = D_, DV = DV_, BK = BK_, kStages = STAGES_;
  static constexpr bool kSplit = BK == 64;
  static_assert(D % 64 == 0 && DV % 64 == 0 && D <= 256 && DV <= 256 && (BK == 64 || BK == 128),
                "64-column boxes, n <= 256 wgmma, 64 or 128 keys a CTA");
  static constexpr int kKBox = BK * 128;        // one 64-column box of K or V
  static constexpr int kQBox = kQT * 128;       // of a Q or dO stage
  static constexpr int kKBytes = D / 64 * kKBox, kVBytes = DV / 64 * kKBox;
  static constexpr int kQBytes = D / 64 * kQBox, kDoBytes = DV / 64 * kQBox;
  struct Smem {
    uint8_t k[kKBytes];
    uint8_t v[kVBytes];
    uint8_t q[kStages][kQBytes];
    uint8_t dout[kStages][kDoBytes];
    float lse[kStages][kQT];                    // log2 units
    float delta[kStages][kQT];
    uint64_t full[kStages];
    uint64_t empty[kStages];
    uint64_t kv_full;
  };
  // The split layout's exchange, after Smem: element i of consumer thread
  // x (0-127 of its warpgroup) at [i][x], and the barriers that hand it over.
  struct Exchange {
    float p[32][128];                           // P^T, fp32
    uint32_t ds[16][128];                       // dS^T, bf16 A fragments
    uint64_t p_full, ds_full;
  };
  static constexpr size_t kSmemBytes = sizeof(Smem) + (kSplit ? sizeof(Exchange) : 0) + 1024;
  static_assert(kSmemBytes <= wg::kMaxSmemBytes, "the dk/dv ring does not fit");
};

// The shapes of each (q/k, v) pair of STEM_WGMMA_PAIR_SWITCH (budgets in
// the header comment).
template <int D, int DV>
struct BwdOf;
template <>
struct BwdOf<64, 64> {
  using Dq = DqShape<64, 64, 128, 4>;
  using Dkdv = DkdvShape<64, 64, 128, 4>;
};
template <>
struct BwdOf<128, 128> {
  using Dq = DqShape<128, 128, 128, 2>;
  using Dkdv = DkdvShape<128, 128, 128, 3>;
};
template <>
struct BwdOf<192, 128> {
  using Dq = DqShape<192, 128, 64, 3>;
  using Dkdv = DkdvShape<192, 128, 64, 3>;
};
template <>
struct BwdOf<192, 192> {
  using Dq = DqShape<192, 192, 64, 2>;
  using Dkdv = DkdvShape<192, 192, 64, 3>;
};
template <>
struct BwdOf<256, 256> {
  using Dq = DqShape<256, 256, 32, 3>;
  using Dkdv = DkdvShape<256, 256, 64, 2>;
};

// launch() with the primary context of `device` (the wrapper's: its
// tensors' card) current on the calling thread, then the thread's former
// device back.  A thread that has made no runtime call yet has no current
// context, e.g. autograd's backward worker when a backward kernel is its
// first launch, and the tensor maps' driver call needs one; cudaSetDevice
// makes it current.  Once a backward call, before any map is encoded.
template <class F>
inline int on_device(int device, F&& launch) {
  int prev = -1;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int err = launch();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

// The number of CTAs the g query heads of a KV head are split over in the
// dk / dv kernel of BK keys a CTA: the smallest divisor of g that gives
// the grid 1.5 CTAs an SM (1 where it has them already, or g = 1).
inline int head_split(int b, int hq, int hk, int n, int bk) {
  static const int sms = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return count;
  }();
  const int g = hq / hk;
  const long long ctas = (long long)b * hk * ((n + bk - 1) / bk);
  int s = 1;
  while (s < g && 2 * ctas * s < 3ll * sms) {
    do ++s;
    while (g % s);
  }
  return s;
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// The producer warpgroup keeps 40 registers, the consumers take 232: 128 *
// (168 - 40) = 256 * (232 - 168).
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// acc += A.B over KS k16 steps at width N: A as bf16 register fragments, B
// MN-major in shared memory at b_addr (rows of 128 bytes, a k16 step 16
// rows apart; lbo = the bytes between its 64-column boxes).
template <int N, int KS>
__device__ __forceinline__ void rs_steps(float (&acc)[N / 2], const uint32_t (&a)[KS][4],
                                         uint32_t b_addr, uint32_t lbo) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wg::wgmma_rs_n<N>(acc, a[kk], wg::wg_desc(b_addr + kk * 16 * 128, lbo, 1024));
}

// acc (=) A.B^T over the K / 16 k16 steps of two K-major operands (A: 64
// rows of boxes a_box bytes apart; B: N rows of boxes b_box apart).
template <int N, int K>
__device__ __forceinline__ void ss_steps(float (&acc)[N / 2], uint32_t a_addr, int a_box,
                                         uint32_t b_addr, int b_box) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t in_box = (kk & 3) * 32;
    wg::wgmma_ss_n<N>(acc, wg::wg_desc(a_addr + (kk >> 2) * a_box + in_box, 16, 1024),
                      wg::wg_desc(b_addr + (kk >> 2) * b_box + in_box, 16, 1024), kk > 0);
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per 128 query rows
// ---------------------------------------------------------------------------
//
// Consumer thread layout as attend_tile's: accumulator element 4j + 2h + e
// of warpgroup c, warp w, lane 4g + t sits at tile row 64c + 16w + g + 8h
// and column 8j + 2t + e.  `tiles` walks the C::BN-key tiles as the
// forward does (k0 from kv_row, off = key 0's token - query row 0's;
// masked where column + off > row).  o, dout, lse, delta, dq: the tile's
// first row.
template <class C, class Tiles>
__device__ __forceinline__ void dq_tile(uint8_t* smem_raw, const CUtensorMap* tq,
                                        const CUtensorMap* tdo, const CUtensorMap* tk,
                                        const CUtensorMap* tv, long long q_row, long long kv_row,
                                        Tiles tiles, const __nv_bfloat16* o,
                                        const __nv_bfloat16* dout, const float* lse,
                                        float* delta, __nv_bfloat16* dq, int valid_rows,
                                        float scale) {
  constexpr int kStages = C::kStages, BN = C::BN, D = C::D, DV = C::DV;
  typename C::Smem& sm = wg::aligned_smem<typename C::Smem>(smem_raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&sm.full_k[s], 1);
      wg::mbar_init(&sm.full_v[s], 1);
      wg::mbar_init(&sm.empty[s], wg::kThreads - 128);
    }
    wg::mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    producer_regs();
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(&sm.q_full, C::kQBytes + C::kDoBytes);
      wg::tma_boxes<D / 64>(sm.q, tq, &sm.q_full, static_cast<int>(q_row), C::kQBox);
      wg::tma_boxes<DV / 64>(sm.dout, tdo, &sm.q_full, static_cast<int>(q_row), C::kQBox);
      int k0, off, it = 0;
      while (tiles.next(k0, off)) {
        const int s = it % kStages;
        wg::mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        const int row = static_cast<int>(kv_row + k0);
        wg::mbar_expect_tx(&sm.full_k[s], C::kKBytes);
        wg::tma_boxes<D / 64>(sm.k[s], tk, &sm.full_k[s], row, C::kKVBox);
        wg::mbar_expect_tx(&sm.full_v[s], C::kVBytes);
        wg::tma_boxes<DV / 64>(sm.v[s], tv, &sm.full_v[s], row, C::kKVBox);
        ++it;
      }
    }
    return;
  }

  consumer_regs();
  const int c = threadIdx.x / 128 - 1;
  const int w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 64 * c + 16 * w + g;
  const float sc = scale * kLog2e;

  // delta = rowsum(dO * O) and lse (log2 units) of rows row0 and row0 + 8:
  // the four threads of a row each read DV / 4 of its columns, 16 bytes at
  // a time
  float dl[2], ls[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    float acc = 0.f;
    if (r < valid_rows) {
#pragma unroll
      for (int i = 0; i < DV / 32; ++i) {
        const int col = 8 * (t + 4 * i);
        const uint4 a = *reinterpret_cast<const uint4*>(o + (long long)r * DV + col);
        const uint4 b = *reinterpret_cast<const uint4*>(dout + (long long)r * DV + col);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(b2[e]);
          acc += x.x * y.x + x.y * y.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[h] = acc;
    ls[h] = r < valid_rows ? lse[r] * kLog2e : INFINITY;   // a row past n: P = 0
    if (t == 0 && r < valid_rows) delta[r] = acc;
  }

  float dqa[D / 2];
  zero(dqa);
  const uint32_t q_addr = wg::smem_u32(sm.q) + c * 64 * 128;
  const uint32_t do_addr = wg::smem_u32(sm.dout) + c * 64 * 128;
  wg::mbar_wait(&sm.q_full, 0);

  int k0, off, it = 0;
  while (tiles.next(k0, off)) {
    const int st = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const bool masked = off > -BN;
    const uint32_t k_addr = wg::smem_u32(sm.k[st]), v_addr = wg::smem_u32(sm.v[st]);
    wg::mbar_wait(&sm.full_k[st], ph);
    wg::mbar_wait(&sm.full_v[st], ph);
    float s[BN / 2], dp[BN / 2];
    zero(s);
    zero(dp);
    wg::fence_regs(s);
    wg::fence_regs(dp);
    wg::wg_fence();
    ss_steps<BN, D>(s, q_addr, C::kQBox, k_addr, C::kKVBox);
    wg::wg_commit();
    ss_steps<BN, DV>(dp, do_addr, C::kQBox, v_addr, C::kKVBox);
    wg::wg_commit();
    wg::wg_wait<1>();
    wg::fence_regs(s);
    // P = exp(S - lse) while dP is in flight; masked entries exact zeros
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          float p = exp2f(s[i] * sc - ls[h]);
          if (masked && 8 * j + 2 * t + e + off > row0 + 8 * h) p = 0.f;
          s[i] = p;
        }
    wg::wg_wait<0>();
    wg::fence_regs(dp);
    uint32_t ds[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, h = r & 1;
        ds[kk][r] = wg::pack_bf16(s[i] * (dp[i] - dl[h]), s[i + 1] * (dp[i + 1] - dl[h]));
      }
    // dQ += dS.K, K MN-major
    wg::fence_regs(dqa);
    wg::wg_fence();
    rs_steps<D, BN / 16>(dqa, ds, k_addr, C::kKVBox);
    wg::wg_commit();
    wg::wg_wait_all();
    wg::fence_regs(dqa);
    wg::mbar_arrive(&sm.empty[st]);
    ++it;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= valid_rows) continue;
    __nv_bfloat16* dst = dq + static_cast<long long>(r) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(dqa[4 * j + 2 * h] * scale, dqa[4 * j + 2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one CTA per C::BK keys
// ---------------------------------------------------------------------------

// The rows r and r + 8 of a 64-row accumulator (element 4j + 2h + e of lane
// 4g + t at row r + 8h, column 8j + 2t + e), times mul, to rows of W bf16.
template <int W>
__device__ __forceinline__ void write_rows(__nv_bfloat16* dst, const float (&acc)[W / 2], int r,
                                           int t, int valid, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= valid) continue;
    __nv_bfloat16* row = dst + static_cast<long long>(r + 8 * h) * W + 2 * t;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// The same rows in fp32, unscaled (a partial of the head split).
template <int W>
__device__ __forceinline__ void write_rows_f32(float* dst, const float (&acc)[W / 2], int r,
                                               int t, int valid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= valid) continue;
    float* row = dst + static_cast<long long>(r + 8 * h) * W + 2 * t;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(acc[4 * j + 2 * h],
                                                            acc[4 * j + 2 * h + 1]);
  }
}

// P^T of a 64-key x 64-query tile in place of S^T (element 4j + 2h + e is
// key krow + 8h against query 8j + 2t + e; lse of the stage in log2 units;
// masked: keys after queries give exact zeros).
__device__ __forceinline__ void p_transposed(float (&s)[32], const float* lse, float sc,
                                             bool masked, int key, int q0, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qc = 8 * j + 2 * t + e;
      const float L = lse[qc];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        float p = exp2f(s[i] * sc - L);
        if (masked && key + 8 * h > q0 + qc) p = 0.f;
        s[i] = p;
      }
    }
}

// `tiles.next(row, q0)` walks the 64-query tiles to sum, in a fixed order:
// row = the tile's first global row in the q / dO maps and in lse / delta
// ((b, hq, n) flat), q0 = its token.  kv_row: the CTA's first key row in
// the k / v maps, k0 its token; n: the sequence (query rows at or past it
// load lse = +inf, delta = 0: they add exact zeros); dk, dv: the CTA's first
// key row; pk, pv: null, or its first row of the fp32 partials of a head
// split (written instead of dk / dv); valid_keys: rows to write.
template <class C, class QTiles>
__device__ __forceinline__ void dkdv_tile(uint8_t* smem_raw, const CUtensorMap* tk,
                                          const CUtensorMap* tv, const CUtensorMap* tq,
                                          const CUtensorMap* tdo, long long kv_row, int k0,
                                          QTiles tiles, const float* lse, const float* delta,
                                          __nv_bfloat16* dk, __nv_bfloat16* dv, float* pk,
                                          float* pv, int n, int valid_keys, float scale) {
  constexpr int kStages = C::kStages, D = C::D, DV = C::DV;
  typename C::Smem& sm = wg::aligned_smem<typename C::Smem>(smem_raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&sm.full[s], 1 + 32);     // the TMA's expect_tx + warp 0's stats
      wg::mbar_init(&sm.empty[s], wg::kThreads - 128);
    }
    wg::mbar_init(&sm.kv_full, 1);
    if constexpr (C::kSplit) {
      typename C::Exchange& x = *reinterpret_cast<typename C::Exchange*>(&sm + 1);
      wg::mbar_init(&x.p_full, 128);
      wg::mbar_init(&x.ds_full, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    producer_regs();
    if (threadIdx.x < 32) {
      // warp 0: lane 0 issues the TMA loads, every lane stores two rows'
      // lse (log2 units) and delta into the stage, then arrives
      const int lane = threadIdx.x;
      if (lane == 0) {
        wg::mbar_expect_tx(&sm.kv_full, C::kKBytes + C::kVBytes);
        wg::tma_boxes<D / 64>(sm.k, tk, &sm.kv_full, static_cast<int>(kv_row), C::kKBox);
        wg::tma_boxes<DV / 64>(sm.v, tv, &sm.kv_full, static_cast<int>(kv_row), C::kKBox);
      }
      long long row;
      int q0, it = 0;
      while (tiles.next(row, q0)) {
        const int s = it % kStages;
        wg::mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          wg::mbar_expect_tx(&sm.full[s], C::kQBytes + C::kDoBytes);
          wg::tma_boxes<D / 64>(sm.q[s], tq, &sm.full[s], static_cast<int>(row), C::kQBox);
          wg::tma_boxes<DV / 64>(sm.dout[s], tdo, &sm.full[s], static_cast<int>(row), C::kQBox);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = lane + 32 * i;
          const bool in = q0 + r < n;
          sm.lse[s][r] = in ? lse[row + r] * kLog2e : INFINITY;
          sm.delta[s][r] = in ? delta[row + r] : 0.f;
        }
        wg::mbar_arrive(&sm.full[s]);
        ++it;
      }
    }
    return;
  }

  consumer_regs();
  const int c = threadIdx.x / 128 - 1;
  const int w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int krow = 16 * w + g;                // the warpgroup's key of h = 0; h = 1 is krow + 8
  const float sc = scale * kLog2e;
  wg::mbar_wait(&sm.kv_full, 0);

  if constexpr (!C::kSplit) {
    // ---- paired: warpgroup c owns keys 64c..64c + 63 and all their work ----
    const int key0 = k0 + 64 * c;             // this warpgroup's first key
    float dka[D / 2], dva[DV / 2];
    zero(dka);
    zero(dva);
    const uint32_t k_addr = wg::smem_u32(sm.k) + c * 64 * 128;
    const uint32_t v_addr = wg::smem_u32(sm.v) + c * 64 * 128;

    long long row;
    int q0, it = 0;
    while (tiles.next(row, q0)) {
      const int st = it % kStages;
      wg::mbar_wait(&sm.full[st], (it / kStages) & 1);
      ++it;
      if (key0 > q0 + kQT - 1) {              // every key after every query: P = 0
        wg::mbar_arrive(&sm.empty[st]);
        continue;
      }
      const bool masked = key0 + 63 > q0;
      const uint32_t q_addr = wg::smem_u32(sm.q[st]), do_addr = wg::smem_u32(sm.dout[st]);
      float s[32], dp[32];
      zero(s);
      zero(dp);
      wg::fence_regs(s);
      wg::fence_regs(dp);
      wg::wg_fence();
      ss_steps<64, D>(s, k_addr, C::kKBox, q_addr, C::kQBox);
      wg::wg_commit();
      ss_steps<64, DV>(dp, v_addr, C::kKBox, do_addr, C::kQBox);
      wg::wg_commit();
      wg::wg_wait<1>();
      wg::fence_regs(s);
      p_transposed(s, sm.lse[st], sc, masked, key0 + krow, q0, t);
      wg::wg_wait<0>();
      wg::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dlt = sm.delta[st][8 * j + 2 * t + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            dp[i] = s[i] * (dp[i] - dlt);
          }
        }
      uint32_t pf[4][4], dsf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pf[kk][r] = wg::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          dsf[kk][r] = wg::pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }
      wg::fence_regs(dva);
      wg::fence_regs(dka);
      wg::wg_fence();
      rs_steps<DV, 4>(dva, pf, do_addr, C::kQBox);    // dV += P^T.dO
      rs_steps<D, 4>(dka, dsf, q_addr, C::kQBox);     // dK += dS^T.Q
      wg::wg_commit();
      wg::wg_wait<0>();
      wg::fence_regs(dva);
      wg::fence_regs(dka);
      wg::mbar_arrive(&sm.empty[st]);
    }
    if (pk != nullptr) {
      write_rows_f32<D>(pk, dka, 64 * c + krow, t, valid_keys);
      write_rows_f32<DV>(pv, dva, 64 * c + krow, t, valid_keys);
    } else {
      write_rows<D>(dk, dka, 64 * c + krow, t, valid_keys, scale);
      write_rows<DV>(dv, dva, 64 * c + krow, t, valid_keys, 1.f);
    }
  } else {
    // ---- split: both warpgroups on the same 64 keys ----
    typename C::Exchange& x = *reinterpret_cast<typename C::Exchange*>(&sm + 1);
    const int tx = threadIdx.x & 127;
    const uint32_t k_addr = wg::smem_u32(sm.k), v_addr = wg::smem_u32(sm.v);
    long long row;
    int q0, it = 0, m = 0;                    // m: tiles exchanged so far
    if (c == 0) {
      // S^T, P^T (to the exchange), then dK += dS^T.Q
      float dka[D / 2];
      zero(dka);
      while (tiles.next(row, q0)) {
        const int st = it % kStages;
        wg::mbar_wait(&sm.full[st], (it / kStages) & 1);
        ++it;
        if (k0 > q0 + kQT - 1) {
          wg::mbar_arrive(&sm.empty[st]);
          continue;
        }
        const uint32_t q_addr = wg::smem_u32(sm.q[st]);
        float s[32];
        zero(s);
        wg::fence_regs(s);
        wg::wg_fence();
        ss_steps<64, D>(s, k_addr, C::kKBox, q_addr, C::kQBox);
        wg::wg_commit();
        wg::wg_wait<0>();
        wg::fence_regs(s);
        p_transposed(s, sm.lse[st], sc, k0 + 63 > q0, k0 + krow, q0, t);
#pragma unroll
        for (int i = 0; i < 32; ++i) x.p[i][tx] = s[i];
        wg::mbar_arrive(&x.p_full);
        wg::mbar_wait(&x.ds_full, m++ & 1);
        uint32_t dsf[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) dsf[kk][r] = x.ds[4 * kk + r][tx];
        wg::fence_regs(dka);
        wg::wg_fence();
        rs_steps<D, 4>(dka, dsf, q_addr, C::kQBox);     // dK += dS^T.Q
        wg::wg_commit();
        wg::wg_wait<0>();
        wg::fence_regs(dka);
        wg::mbar_arrive(&sm.empty[st]);
      }
      if (pk != nullptr)
        write_rows_f32<D>(pk, dka, krow, t, valid_keys);
      else
        write_rows<D>(dk, dka, krow, t, valid_keys, scale);
    } else {
      // dP^T, dS^T (to the exchange) from P^T, then dV += P^T.dO
      float dva[DV / 2];
      zero(dva);
      while (tiles.next(row, q0)) {
        const int st = it % kStages;
        wg::mbar_wait(&sm.full[st], (it / kStages) & 1);
        ++it;
        if (k0 > q0 + kQT - 1) {
          wg::mbar_arrive(&sm.empty[st]);
          continue;
        }
        const uint32_t do_addr = wg::smem_u32(sm.dout[st]);
        float dp[32];
        zero(dp);
        wg::fence_regs(dp);
        wg::wg_fence();
        ss_steps<64, DV>(dp, v_addr, C::kKBox, do_addr, C::kQBox);
        wg::wg_commit();
        wg::wg_wait<0>();
        wg::fence_regs(dp);
        wg::mbar_wait(&x.p_full, m++ & 1);
        // dS^T = P^T * (dP^T - delta), packed and handed over; P^T packed
        // for dV before the barrier lets warpgroup 0 write the next tile's
        uint32_t pf[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float p[2], d2[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 8 * kk + 2 * r + e;
              p[e] = x.p[i][tx];
              d2[e] = p[e] * (dp[i] - sm.delta[st][8 * (i >> 2) + 2 * t + e]);
            }
            pf[kk][r] = wg::pack_bf16(p[0], p[1]);
            x.ds[4 * kk + r][tx] = wg::pack_bf16(d2[0], d2[1]);
          }
        wg::mbar_arrive(&x.ds_full);
        wg::fence_regs(dva);
        wg::wg_fence();
        rs_steps<DV, 4>(dva, pf, do_addr, C::kQBox);    // dV += P^T.dO
        wg::wg_commit();
        wg::wg_wait<0>();
        wg::fence_regs(dva);
        wg::mbar_arrive(&sm.empty[st]);
      }
      if (pv != nullptr)
        write_rows_f32<DV>(pv, dva, krow, t, valid_keys);
      else
        write_rows<DV>(dv, dva, krow, t, valid_keys, 1.f);
    }
  }
}

// The head split's second pass: dk = bf16(scale * sum_s pk[s]) and dv =
// bf16(sum_s pv[s]), s = 0..S-1 in order; part holds pk (S, rows, d) then
// pv (S, rows, dv) in fp32.  Four elements a thread, grid-stride.
__global__ void __launch_bounds__(256)
reduce_kv_partials(const float* __restrict__ part, int S, long long rows, int d, int dv,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dvo,
                   float scale) {
  const long long nk = rows * d / 4, nv = rows * dv / 4;
  const float4* pk = reinterpret_cast<const float4*>(part);
  const float4* pv = pk + S * nk;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < nk + nv;
       i += (long long)gridDim.x * blockDim.x) {
    const bool is_k = i < nk;
    const long long j = is_k ? i : i - nk, stride = is_k ? nk : nv;
    const float4* src = (is_k ? pk : pv) + j;
    float4 a = src[0];
    for (int s = 1; s < S; ++s) {
      const float4 b = src[s * stride];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    const float mul = is_k ? scale : 1.f;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>((is_k ? dk : dvo) + 4 * j);
    dst[0] = __floats2bfloat162_rn(a.x * mul, a.y * mul);
    dst[1] = __floats2bfloat162_rn(a.z * mul, a.w * mul);
  }
}

// Launches reduce_kv_partials over b * hk * n key rows.
inline cudaError_t launch_reduce(const float* part, int S, long long rows, int d, int dv,
                                 void* dk, void* dvo, float scale, cudaStream_t stream) {
  const long long work = rows * (d + dv) / 4;
  const int blocks = static_cast<int>(std::min<long long>((work + 255) / 256, 4096));
  reduce_kv_partials<<<blocks, 256, 0, stream>>>(part, S, rows, d, dv, (__nv_bfloat16*)dk,
                                                  (__nv_bfloat16*)dvo, scale);
  return cudaGetLastError();
}

}  // namespace stem_bwg
