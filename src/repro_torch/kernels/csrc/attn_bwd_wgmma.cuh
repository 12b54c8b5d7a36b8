// Shared device code of the bf16 attention backward kernels on Hopper's
// tensor cores (flash_attention.cu, block_sparse_attn.cu), at q/k = v
// head_dim 128: the route the wrappers' backward_route names "wgmma" (bf16,
// d = dv = 128, a block-sparse block that is a multiple of 128).  Every
// other shape runs attn_bwd.cuh's CUDA-core tiles.
//
// With S = scale * Q.K^T, P = exp(S - lse), dP = dO.V^T, delta = rowsum(dO
// * O) and dS = P * (dP - delta):  dQ = scale * dS.K,  dK = scale * dS^T.Q,
// dV = P^T.dO.  lse is the forward's: its kernels save each row's
// natural-log log-sum-exp (+inf for a row that saw no key, so P = 0).
// Two kernels, no atomics (a fixed summation order, bitwise run to run):
//
//   dq_tile    one CTA per 128 query rows of a (batch, query head), the
//              forward's attend_tile with a second operand: Q and dO
//              resident (32 + 32 KiB), K and V streamed by TMA through a
//              two-stage ring (2 x 64 KiB).  Per 128-key tile each consumer
//              warpgroup (64 rows) issues S = Q.K^T and dP = dO.V^T
//              (m64n128k16, both operands K-major), forms P and dS in
//              registers while dP is in flight, rounds dS to bf16 as the
//              register A operand of dQ += dS.K (K read MN-major through the
//              transpose bit, as the forward reads V).  delta is computed
//              in the prologue from O and dO and written for the second
//              kernel.
//   dkdv_tile  one CTA per 128 keys of a (batch, KV head): K and V resident
//              (64 KiB), Q and dO streamed as 64-query tiles through a
//              three-stage ring (16 + 16 KiB a stage) with each tile's lse
//              and delta (loaded by the producer's first warp into the
//              stage).  Per query tile each consumer warpgroup (64 keys):
//              S^T = K.Q^T and dP^T = V.dO^T (m64n64k16), P^T and dS^T in
//              registers rounded to bf16, dV += P^T.dO and dK += dS^T.Q
//              (m64n128k16, A from registers, B MN-major).  64-query tiles
//              keep dK 64 + dV 64 + S^T 32 + dP^T 32 floats a thread under
//              the consumers' 232 registers.  The CTA walks the query heads
//              of its KV head and their query tiles in a fixed order.
//
// P and dS are rounded to bf16 before their products (as SDPA's backward
// does); the plain version keeps them in fp32, hence the p_bf16 rule.
// Bound: 2 * (3 d + 2 dv) flops a causal pair (S, dP, dV, dK, dQ) on 989
// TFLOP/s bf16; the split without atomics recomputes S and dP in both
// kernels, 7 products a pair.  Layouts are attn_wgmma.cuh's: 128-byte
// swizzled 64-column boxes, 128 rows (32 KiB tiles) or 64 rows (16 KiB).
#pragma once

#include "attn_wgmma.cuh"

namespace stem_bwg {

namespace wg = stem_wg;

constexpr int kQT = 64;                       // query rows of a dk/dv stage
constexpr int kQBoxBytes = kQT * 64 * 2;      // 64 rows x 64 bf16
constexpr int kQTileBytes = 2 * kQBoxBytes;   // 64 rows x 128 bf16
constexpr int kKvStages = wg::kStages;        // dq kernel: K / V ring
constexpr int kQStages = 3;                   // dk/dv kernel: Q / dO ring
constexpr float kLog2e = 1.4426950408889634f;

struct DqSmem {
  uint8_t q[wg::kTileBytes];
  uint8_t dout[wg::kTileBytes];
  uint8_t k[kKvStages][wg::kTileBytes];
  uint8_t v[kKvStages][wg::kTileBytes];
  uint64_t full_k[kKvStages];
  uint64_t full_v[kKvStages];
  uint64_t empty[kKvStages];
  uint64_t q_full;
};

struct DkdvSmem {
  uint8_t k[wg::kTileBytes];
  uint8_t v[wg::kTileBytes];
  uint8_t q[kQStages][kQTileBytes];
  uint8_t dout[kQStages][kQTileBytes];
  float lse[kQStages][kQT];                   // log2 units
  float delta[kQStages][kQT];
  uint64_t full[kQStages];
  uint64_t empty[kQStages];
  uint64_t kv_full;
};

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

// acc += A.B over KS k16 steps: A as bf16 register fragments, B MN-major in
// shared memory at b_addr (128 rows of 128 bytes a k16 step apart: 16 rows;
// lbo = the box bytes between its two 64-column halves).
template <int KS>
__device__ __forceinline__ void rs_steps(float (&acc)[64], const uint32_t (&a)[KS][4],
                                         uint32_t b_addr, uint32_t lbo) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wg::wgmma_rs(acc, a[kk], wg::wg_desc(b_addr + kk * 16 * 128, lbo, 1024));
}

// ---------------------------------------------------------------------------
// dQ: one CTA per 128 query rows
// ---------------------------------------------------------------------------
//
// Consumer thread layout as attend_tile's: accumulator element 4j + 2h + e
// of warpgroup c, warp w, lane 4g + t sits at tile row 64c + 16w + g + 8h
// and column 8j + 2t + e.  `tiles` walks the key tiles as the forward does
// (k0 from kv_row, off = key 0's token - query row 0's; masked where
// column + off > row).  o, dout, lse, delta, dq: the tile's first row.
template <class Tiles>
__device__ __forceinline__ void dq_tile(uint8_t* smem_raw, const CUtensorMap* tq,
                                        const CUtensorMap* tdo, const CUtensorMap* tk,
                                        const CUtensorMap* tv, long long q_row, long long kv_row,
                                        Tiles tiles, const __nv_bfloat16* o,
                                        const __nv_bfloat16* dout, const float* lse,
                                        float* delta, __nv_bfloat16* dq, int valid_rows,
                                        float scale) {
  DqSmem& sm = wg::aligned_smem<DqSmem>(smem_raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kKvStages; ++s) {
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
      wg::mbar_expect_tx(&sm.q_full, 2 * wg::kTileBytes);
      wg::tma_tile(sm.q, tq, &sm.q_full, static_cast<int>(q_row));
      wg::tma_tile(sm.dout, tdo, &sm.q_full, static_cast<int>(q_row));
      int k0, off, it = 0;
      while (tiles.next(k0, off)) {
        const int s = it % kKvStages;
        wg::mbar_wait(&sm.empty[s], ((it / kKvStages) & 1) ^ 1);
        const int row = static_cast<int>(kv_row + k0);
        wg::mbar_expect_tx(&sm.full_k[s], wg::kTileBytes);
        wg::tma_tile(sm.k[s], tk, &sm.full_k[s], row);
        wg::mbar_expect_tx(&sm.full_v[s], wg::kTileBytes);
        wg::tma_tile(sm.v[s], tv, &sm.full_v[s], row);
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
  // the four threads of a row each read 32 of its columns, 16 bytes at a time
  float dl[2], ls[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    float acc = 0.f;
    if (r < valid_rows) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 8 * (t + 4 * i);
        const uint4 a = *reinterpret_cast<const uint4*>(o + (long long)r * wg::kD + col);
        const uint4 b = *reinterpret_cast<const uint4*>(dout + (long long)r * wg::kD + col);
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

  float dqa[64];
  zero(dqa);
  const uint32_t q_addr = wg::smem_u32(sm.q) + c * 64 * 128;
  const uint32_t do_addr = wg::smem_u32(sm.dout) + c * 64 * 128;
  wg::mbar_wait(&sm.q_full, 0);

  int k0, off, it = 0;
  while (tiles.next(k0, off)) {
    const int st = it % kKvStages;
    const uint32_t ph = (it / kKvStages) & 1;
    const bool masked = off > -wg::kBN;
    const uint32_t k_addr = wg::smem_u32(sm.k[st]), v_addr = wg::smem_u32(sm.v[st]);
    wg::mbar_wait(&sm.full_k[st], ph);
    wg::mbar_wait(&sm.full_v[st], ph);
    float s[64], dp[64];
    zero(s);
    zero(dp);
    wg::fence_regs(s);
    wg::fence_regs(dp);
    wg::wg_fence();
#pragma unroll
    for (int kk = 0; kk < wg::kD / 16; ++kk) {
      const uint32_t o16 = (kk >> 2) * wg::kBoxBytes + (kk & 3) * 32;
      wg::wgmma_ss(s, wg::wg_desc(q_addr + o16, 16, 1024), wg::wg_desc(k_addr + o16, 16, 1024),
                   kk > 0);
    }
    wg::wg_commit();
#pragma unroll
    for (int kk = 0; kk < wg::kD / 16; ++kk) {
      const uint32_t o16 = (kk >> 2) * wg::kBoxBytes + (kk & 3) * 32;
      wg::wgmma_ss(dp, wg::wg_desc(do_addr + o16, 16, 1024), wg::wg_desc(v_addr + o16, 16, 1024),
                   kk > 0);
    }
    wg::wg_commit();
    wg::wg_wait<1>();
    wg::fence_regs(s);
    // P = exp(S - lse) while dP is in flight; masked entries exact zeros
#pragma unroll
    for (int j = 0; j < 16; ++j)
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
    uint32_t ds[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, h = r & 1;
        ds[kk][r] = wg::pack_bf16(s[i] * (dp[i] - dl[h]), s[i + 1] * (dp[i + 1] - dl[h]));
      }
    wg::value_tile(dqa, ds, k_addr);          // dQ += dS.K, K MN-major
    wg::mbar_arrive(&sm.empty[st]);
    ++it;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= valid_rows) continue;
    __nv_bfloat16* dst = dq + static_cast<long long>(r) * wg::kD + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(dqa[4 * j + 2 * h] * scale, dqa[4 * j + 2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one CTA per 128 keys
// ---------------------------------------------------------------------------
//
// `tiles.next(row, q0)` walks the 64-query tiles to sum, in a fixed order:
// row = the tile's first global row in the q / dO maps and in lse / delta
// ((b, hq, n) flat), q0 = its token.  kv_row: the CTA's first key row in
// the k / v maps, k0 its token; n: the sequence (query rows at or past it
// load lse = +inf, delta = 0: they add exact zeros); dk, dv: the CTA's first
// key row; valid_keys: rows to write.
template <class QTiles>
__device__ __forceinline__ void dkdv_tile(uint8_t* smem_raw, const CUtensorMap* tk,
                                          const CUtensorMap* tv, const CUtensorMap* tq,
                                          const CUtensorMap* tdo, long long kv_row, int k0,
                                          QTiles tiles, const float* lse, const float* delta,
                                          __nv_bfloat16* dk, __nv_bfloat16* dv, int n,
                                          int valid_keys, float scale) {
  DkdvSmem& sm = wg::aligned_smem<DkdvSmem>(smem_raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kQStages; ++s) {
      wg::mbar_init(&sm.full[s], 1 + 32);     // the TMA's expect_tx + warp 0's stats
      wg::mbar_init(&sm.empty[s], wg::kThreads - 128);
    }
    wg::mbar_init(&sm.kv_full, 1);
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
        wg::mbar_expect_tx(&sm.kv_full, 2 * wg::kTileBytes);
        wg::tma_tile(sm.k, tk, &sm.kv_full, static_cast<int>(kv_row));
        wg::tma_tile(sm.v, tv, &sm.kv_full, static_cast<int>(kv_row));
      }
      long long row;
      int q0, it = 0;
      while (tiles.next(row, q0)) {
        const int s = it % kQStages;
        wg::mbar_wait(&sm.empty[s], ((it / kQStages) & 1) ^ 1);
        if (lane == 0) {
          wg::mbar_expect_tx(&sm.full[s], 2 * kQTileBytes);
          wg::tma_tile(sm.q[s], tq, &sm.full[s], static_cast<int>(row), kQBoxBytes);
          wg::tma_tile(sm.dout[s], tdo, &sm.full[s], static_cast<int>(row), kQBoxBytes);
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
  const int key0 = k0 + 64 * c;               // this warpgroup's first key
  const int krow = 16 * w + g;                // its key of h = 0; h = 1 is krow + 8
  const float sc = scale * kLog2e;
  float dka[64], dva[64];
  zero(dka);
  zero(dva);
  const uint32_t k_addr = wg::smem_u32(sm.k) + c * 64 * 128;
  const uint32_t v_addr = wg::smem_u32(sm.v) + c * 64 * 128;
  wg::mbar_wait(&sm.kv_full, 0);

  long long row;
  int q0, it = 0;
  while (tiles.next(row, q0)) {
    const int st = it % kQStages;
    wg::mbar_wait(&sm.full[st], (it / kQStages) & 1);
    ++it;
    if (key0 > q0 + kQT - 1) {                // every key after every query: P = 0
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
#pragma unroll
    for (int kk = 0; kk < wg::kD / 16; ++kk) {
      const uint32_t oa = (kk >> 2) * wg::kBoxBytes + (kk & 3) * 32;
      const uint32_t ob = (kk >> 2) * kQBoxBytes + (kk & 3) * 32;
      wg::wgmma_ss64(s, wg::wg_desc(k_addr + oa, 16, 1024), wg::wg_desc(q_addr + ob, 16, 1024),
                     kk > 0);
    }
    wg::wg_commit();
#pragma unroll
    for (int kk = 0; kk < wg::kD / 16; ++kk) {
      const uint32_t oa = (kk >> 2) * wg::kBoxBytes + (kk & 3) * 32;
      const uint32_t ob = (kk >> 2) * kQBoxBytes + (kk & 3) * 32;
      wg::wgmma_ss64(dp, wg::wg_desc(v_addr + oa, 16, 1024), wg::wg_desc(do_addr + ob, 16, 1024),
                     kk > 0);
    }
    wg::wg_commit();
    wg::wg_wait<1>();
    wg::fence_regs(s);
    // P^T: element 4j + 2h + e is key krow + 8h against query 8j + 2t + e
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * j + 2 * t + e;
        const float L = sm.lse[st][qc];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          float p = exp2f(s[i] * sc - L);
          if (masked && key0 + krow + 8 * h > q0 + qc) p = 0.f;
          s[i] = p;
        }
      }
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
    rs_steps<4>(dva, pf, do_addr, kQBoxBytes);    // dV += P^T.dO
    rs_steps<4>(dka, dsf, q_addr, kQBoxBytes);    // dK += dS^T.Q
    wg::wg_commit();
    wg::wg_wait<0>();
    wg::fence_regs(dva);
    wg::fence_regs(dka);
    wg::mbar_arrive(&sm.empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * c + krow + 8 * h;
    if (r >= valid_keys) continue;
    __nv_bfloat16* dkr = dk + static_cast<long long>(r) * wg::kD + 2 * t;
    __nv_bfloat16* dvr = dv + static_cast<long long>(r) * wg::kD + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2 * h] * scale, dka[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
    }
  }
}

constexpr size_t kDqSmemBytes = sizeof(DqSmem) + 1024;      // + room to align the base
constexpr size_t kDkdvSmemBytes = sizeof(DkdvSmem) + 1024;

}  // namespace stem_bwg
