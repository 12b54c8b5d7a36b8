// Shared device code of the bf16 one-shot prefill attention kernels
// (flash_attention.cu, block_sparse_attn.cu) on Hopper's tensor cores:
// TMA loads into a shared-memory ring, warpgroup MMA (wgmma) products with
// fp32 accumulation, and the online softmax in registers.
//
// One CTA owns 128 query rows of one (batch, query head) at head_dim 128
// and walks a sequence of 128-key tiles that the kernel names (a `Tiles`
// iterator: flash walks 0..diagonal, block-sparse the row's selected
// blocks, the paged chunk lane the row's selected pages through the page
// table).  384 threads in three warpgroups:
//
//   * warpgroup 0, the producer, gives its registers up (setmaxnreg) and one
//     thread issues the TMA loads: Q once, then for each key tile a K and a
//     V tile into a ring of kStages stages, each stage with a "full"
//     mbarrier per operand (TMA completes the transaction bytes) and one
//     "empty" mbarrier (every consumer thread arrives after its P.V);
//   * warpgroups 1 and 2, the consumers, own query rows 0-63 and 64-127 of
//     the tile.  Per key tile: S = Q.K^T by 8 wgmma.m64n128k16 with A and B
//     both K-major in shared memory; the online softmax on S's registers
//     (exp2f, scale * log2 e folded into one multiply, the causal mask only
//     on a tile that is not wholly visible); P rounded to bf16 in registers
//     becomes the A
//     operand of O += P.V (8 more wgmma, V read MN-major through the
//     transpose bit).  The accumulator layout of S is the register layout
//     of wgmma's A operand, so P never touches shared memory.
//
// Layout: a 128 x 128 bf16 tile is two TMA boxes of 128 rows x 64 columns
// (128 bytes a row) with CU_TENSOR_MAP_SWIZZLE_128B; the wgmma descriptors
// use the same 128-byte swizzle: K-major operands step 32 bytes per k16
// inside a box and move to the second box at k = 64 (stride between 8-row
// groups 1024 bytes); V as the MN-major operand steps 16 rows (2048 bytes)
// per k16, with the second box (d 64..127) 16 KiB on.  Every buffer is
// 1024-byte aligned, so the hardware's swizzle phase matches TMA's.
//
// Shared memory: Q 32 KiB + kStages x (K 32 KiB + V 32 KiB) = 160 KiB at
// two stages: one CTA per SM.  Bound: 4 * 128 flops per (query, key) pair
// against one read of q, k, v: compute-bound on the H100 at 989 TFLOP/s bf16.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace stem_wg {

constexpr int kD = 128;                      // head_dim
constexpr int kBM = 128;                     // query rows per CTA
constexpr int kBN = 128;                     // keys per tile
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr int kBoxBytes = 128 * 64 * 2;      // 128 rows x 64 bf16: one swizzled box
constexpr int kTileBytes = 2 * kBoxBytes;    // 128 rows x 128 bf16

struct Smem {
  uint8_t q[kTileBytes];
  uint8_t k[kStages][kTileBytes];
  uint8_t v[kStages][kTileBytes];
  uint64_t full_k[kStages];
  uint64_t full_v[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;   // + room to align the base

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The Smem of a CTA inside its dynamic shared memory, 1024-byte aligned.
__device__ __forceinline__ Smem& aligned_smem(uint8_t* smem_raw) {
  const uint32_t raw = smem_u32(smem_raw);
  return *reinterpret_cast<Smem*>(smem_raw + (((raw + 1023) & ~1023u) - raw));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of the given parity has completed.  A wait of more
// than 2^34 cycles (~9 s) traps: a phase fault fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// One 128-row x 64-column box at (column c0, row c1) of a 2-D tensor map.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                        int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The 128 x 128 tile whose first row is `row`: two 64-column boxes.
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row) {
  tma_box(dst, map, bar, 0, row);
  tma_box(dst + kBoxBytes, map, bar, 64, row);
}

// wgmma shared-memory descriptor, 128-byte swizzle.  lbo / sbo in bytes.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins the accumulator registers in program order around the asynchronous
// wgmma (the compiler sees no dependence between wgmma.wait and them).
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define STEM_ACC64                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "  \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define STEM_D8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define STEM_D64 \
  STEM_D8(0), STEM_D8(8), STEM_D8(16), STEM_D8(24), STEM_D8(32), STEM_D8(40), STEM_D8(48), STEM_D8(56)

// d (+)= A.B for a 64 x 128 x 16 step, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " STEM_ACC64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : STEM_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A.B for a 64 x 128 x 16 step, A (bf16 pairs) in registers, B
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " STEM_ACC64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : STEM_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef STEM_D64
#undef STEM_D8
#undef STEM_ACC64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// The tile
// ---------------------------------------------------------------------------
//
// Accumulator layout of a consumer thread (warp w of its warpgroup, lane =
// 4 * g + t): element 4j + 2h + e sits at row 16w + g + 8h of the
// warpgroup's 64 rows and column 8j + 2t + e.

// S = Q.K^T of this warpgroup's 64 rows against the 128 keys of a stage.
__device__ __forceinline__ void score_tile(float (&s)[64], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  fence_regs(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
    wgmma_ss(s, wg_desc(q_addr + off, 16, 1024), wg_desc(k_addr + off, 16, 1024), kk > 0);
  }
  wg_commit();
  wg_wait_all();
  fence_regs(s);
}

// O += P.V over the 128 keys of a stage; p holds P as bf16 A fragments.
__device__ __forceinline__ void value_tile(float (&o)[64], const uint32_t (&p)[8][4],
                                           uint32_t v_addr) {
  fence_regs(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_rs(o, p[kk], wg_desc(v_addr + kk * 16 * 128, kBoxBytes, 1024));
  wg_commit();
  wg_wait_all();
  fence_regs(o);
}

// The producer / consumer pipeline of one CTA.  `tiles.next(k0, off)`
// yields the row offset k0 (from kv_row) of each 128-key tile to attend,
// and off = (token of its key 0) - (token of query row 0): key column c is
// masked from query row r where c + off > r, so a tile with off <= -kBN is
// wholly visible and takes no mask (flash and block-sparse give off = 0 on
// their diagonal tile; the paged chunk lane any offset, for a chunk that
// starts anywhere).  Producer and consumers walk their own copies of the
// same sequence.  q_row / kv_row: the first global row of the Q tile and of
// the KV head in the tensor maps; out: the tile's first output row;
// valid_rows: rows of the tile to write.
template <class Tiles>
__device__ __forceinline__ void attend_tile(uint8_t* smem_raw, const CUtensorMap* tq,
                                            const CUtensorMap* tk, const CUtensorMap* tv,
                                            long long q_row, long long kv_row, Tiles tiles,
                                            __nv_bfloat16* out, int valid_rows, float scale) {
  Smem& sm = aligned_smem(smem_raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full_k[s], 1);
      mbar_init(&sm.full_v[s], 1);
      mbar_init(&sm.empty[s], kThreads - 128);
    }
    mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, kTileBytes);
      tma_tile(sm.q, tq, &sm.q_full, static_cast<int>(q_row));
      int k0, off, it = 0;
      while (tiles.next(k0, off)) {
        const int s = it % kStages;
        mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        const int row = static_cast<int>(kv_row + k0);
        mbar_expect_tx(&sm.full_k[s], kTileBytes);
        tma_tile(sm.k[s], tk, &sm.full_k[s], row);
        mbar_expect_tx(&sm.full_v[s], kTileBytes);
        tma_tile(sm.v[s], tv, &sm.full_v[s], row);
        ++it;
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1;
    const int w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = 64 * c + 16 * w + g;        // tile row of h = 0; h = 1 is row0 + 8
    const float sc = scale * 1.4426950408889634f;  // scores in log2 units
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_addr = smem_u32(sm.q) + c * 64 * 128;
    mbar_wait(&sm.q_full, 0);

    int k0, off, it = 0;
    while (tiles.next(k0, off)) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const bool masked = off > -kBN;
      mbar_wait(&sm.full_k[st], ph);
      float s[64];
      score_tile(s, q_addr, smem_u32(sm.k[st]));

      // online softmax; a row that has seen no key yet (m = -inf, possible
      // on a partly visible tile) exponentiates against 0, not -inf, so it
      // adds exact zeros instead of NaN
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[4 * j + 2 * h + e] * sc;
            if (masked && 8 * j + 2 * t + e + off > row0 + 8 * h) x = -INFINITY;
            s[4 * j + 2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m[h] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[4 * j + 2 * h + e] - m_use);
            s[4 * j + 2 * h + e] = p;
            sum += p;
          }
        l[h] = l[h] * corr + sum;                // this thread's share of the row
        m[h] = m_new;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          o[4 * j + 2 * h] *= corr;
          o[4 * j + 2 * h + 1] *= corr;
        }
      }
      uint32_t p[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      mbar_wait(&sm.full_v[st], ph);
      value_tile(o, p, smem_u32(sm.v[st]));
      mbar_arrive(&sm.empty[st]);
      ++it;
    }

    // finalize: acc / max(l, 1e-20), so a row that attended nothing is 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float den = fmaxf(lt, 1e-20f);
      const int r = row0 + 8 * h;
      if (r >= valid_rows) continue;
      __nv_bfloat16* dst = out + static_cast<long long>(r) * kD + 2 * t;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] / den, o[4 * j + 2 * h + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: fetched through the runtime, so
// the library links no libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &res) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) !=
        cudaSuccess)
      return nullptr;
#endif
    return res == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A (rows, 128) bf16 row-major matrix as a tensor map of 128-row x 64-column
// boxes with the 128-byte swizzle.  base must be 16-byte aligned.
inline bool make_map(CUtensorMap* map, const void* base, long long rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || rows <= 0 || rows >= (1ll << 31)) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {kD * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, 128};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of q (b * hq * n rows) and of k and v (b * hk * n rows each).
inline bool make_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv, const void* q,
                      const void* k, const void* v, int b, int hq, int hk, int n) {
  return make_map(tq, q, (long long)b * hq * n) && make_map(tk, k, (long long)b * hk * n) &&
         make_map(tv, v, (long long)b * hk * n);
}

template <typename Kernel>
inline cudaError_t prepare(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmemBytes));
}

}  // namespace stem_wg
