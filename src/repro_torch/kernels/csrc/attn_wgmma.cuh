// Shared device code of the bf16 one-shot prefill attention kernels
// (flash_attention.cu, block_sparse_attn.cu) and the paged chunk lane on
// Hopper's tensor cores: TMA loads into a shared-memory ring, warpgroup MMA
// (wgmma) products with fp32 accumulation, and the online softmax in
// registers.
//
// The tile is a template over its shape (Shape<D, DV, BN, STAGES>: q/k
// head_dim D, v head_dim DV, BN keys a tile, a ring of STAGES stages);
// TileOf<D, DV> is the shape each (q/k, v) pair of the prefill kernels runs
// at, and Tile128 (d = dv = 128, 128-key tiles, two stages) the one the
// paged chunk lane and the backward kernels (attn_bwd_wgmma.cuh) share.
// One CTA owns 128 query rows of one (batch, query head) and walks a
// sequence of BN-key tiles that the kernel names (a `Tiles` iterator:
// flash walks 0..diagonal, block-sparse the row's selected blocks, the
// paged chunk lane the row's selected pages through the page table).  384
// threads in three warpgroups:
//
//   * warpgroup 0, the producer, gives its registers up (setmaxnreg) and one
//     thread issues the TMA loads: Q once, then for each key tile a K and a
//     V tile into the ring, each stage with a "full" mbarrier per operand
//     (TMA completes the transaction bytes) and one "empty" mbarrier (every
//     consumer thread arrives after its P.V);
//   * warpgroups 1 and 2, the consumers, own query rows 0-63 and 64-127 of
//     the tile.  Per key tile: S = Q.K^T by D / 16 wgmma.m64nBNk16 with A
//     and B both K-major in shared memory; the online softmax on S's
//     registers (exp2f, scale * log2 e folded into one multiply, the causal
//     mask only on a tile that is not wholly visible); P rounded to bf16 in
//     registers becomes the A operand of O += P.V (BN / 16 wgmma.m64nDVk16,
//     V read MN-major through the transpose bit).  The accumulator layout of
//     S is the register layout of wgmma's A operand, so P never touches
//     shared memory.  On request the epilogue stores each row's log-sum-exp
//     (m ln 2 + ln l, natural log; +inf where the row saw no key) for the
//     backward.
//
// Layout: a tile of R rows x W bf16 columns is W / 64 TMA boxes of R rows x
// 64 columns (128 bytes a row) with CU_TENSOR_MAP_SWIZZLE_128B; the wgmma
// descriptors use the same 128-byte swizzle: K-major operands step 32 bytes
// per k16 inside a box and move to the next box every k 64 (stride between
// 8-row groups 1024 bytes); V as the MN-major operand steps 16 rows (2048
// bytes) per k16, its 64-column boxes BN x 128 bytes apart (the
// descriptor's leading offset).  Every buffer is 1024-byte aligned, so the
// hardware's swizzle phase matches TMA's.
//
// Shapes (shared memory of 227 KiB; registers: 240 a consumer thread, S
// BN / 2, O DV / 2 and P BN / 4 of them):
//   (64, 64)    BN 128, 4 stages: Q 16 KiB + 4 x (16 + 16) = 144 KiB
//   (128, 128)  BN 128, 2 stages: Q 32 KiB + 2 x (32 + 32) = 160 KiB
//   (192, 128)  BN 128, 2 stages: Q 48 KiB + 2 x (48 + 32) = 208 KiB
//   (192, 192)  BN  64, 3 stages: Q 48 KiB + 3 x (24 + 24) = 192 KiB
//   (256, 256)  BN  64, 2 stages: Q 64 KiB + 2 x (32 + 32) = 192 KiB
// one CTA per SM.  At (256, 256) a consumer thread holds O's 128 registers
// besides S's 32 and P's 16: flash fits, block-sparse (whose walk of the
// selection adds nine) spills around each S product.  Bound: 2 * (D + DV) flops per (query, key) pair against
// one read of q, k, v: compute-bound on the H100 at 989 TFLOP/s bf16.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace stem_wg {

constexpr int kBM = 128;                     // query rows per CTA
constexpr int kThreads = 384;
constexpr size_t kMaxSmemBytes = 232448;     // 227 KiB: a CTA's dynamic shared memory

// The tile at q/k head_dim D, v head_dim DV, BN keys a tile and a ring of
// STAGES stages.
template <int D_, int DV_, int BN_, int STAGES_>
struct Shape {
  static constexpr int D = D_, DV = DV_, BN = BN_, kStages = STAGES_;
  static_assert(D % 64 == 0 && DV % 64 == 0 && DV <= 256 && (BN == 64 || BN == 128),
                "the tile takes 64-column boxes, n <= 256 wgmma and 64 / 128-key tiles");
  static constexpr int kQBox = kBM * 128;     // bytes of one 64-column box of Q
  static constexpr int kKVBox = BN * 128;     // of K or V
  static constexpr int kQBytes = D / 64 * kQBox;
  static constexpr int kKBytes = D / 64 * kKVBox;
  static constexpr int kVBytes = DV / 64 * kKVBox;
  struct Smem {
    uint8_t q[kQBytes];
    uint8_t k[kStages][kKBytes];
    uint8_t v[kStages][kVBytes];
    uint64_t full_k[kStages];
    uint64_t full_v[kStages];
    uint64_t empty[kStages];
    uint64_t q_full;
  };
  static constexpr size_t kSmemBytes = sizeof(Smem) + 1024;   // + room to align the base
  static_assert(kSmemBytes <= kMaxSmemBytes, "the tile's ring does not fit");
};

// The shape of each (q/k, v) pair the prefill kernels run on this tile
// (head_dims.cuh STEM_WGMMA_PAIR_SWITCH): 128-key tiles while a stage of K
// and V at BN 128 leaves room for two stages beside Q, else 64; as many
// stages as fit, up to 4, but 2 at d = dv = 128 (Tile128, shared with the
// paged chunk lane and the backward).
template <int D, int DV>
using TileOf = Shape<D, DV, (D + DV <= 320 ? 128 : 64),
                     (D + DV <= 128 ? 4 : D + DV == 384 ? 3 : 2)>;

using Tile128 = TileOf<128, 128>;
using Smem = Tile128::Smem;
constexpr int kD = Tile128::D;               // head_dim of Tile128
constexpr int kBN = Tile128::BN;             // keys per tile of Tile128
constexpr int kStages = Tile128::kStages;
constexpr int kBoxBytes = Tile128::kQBox;    // 128 rows x 64 bf16: one swizzled box
constexpr int kTileBytes = 2 * kBoxBytes;    // 128 rows x 128 bf16
constexpr size_t kSmemBytes = Tile128::kSmemBytes;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The S (Smem, or a backward kernel's layout) of a CTA inside its dynamic
// shared memory, 1024-byte aligned.
template <class S = Smem>
__device__ __forceinline__ S& aligned_smem(uint8_t* smem_raw) {
  const uint32_t raw = smem_u32(smem_raw);
  return *reinterpret_cast<S*>(smem_raw + (((raw + 1023) & ~1023u) - raw));
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

// The NB * 64-column tile whose first row is `row`: NB boxes of box_bytes.
template <int NB>
__device__ __forceinline__ void tma_boxes(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int row, int box_bytes) {
#pragma unroll
  for (int i = 0; i < NB; ++i) tma_box(dst + i * box_bytes, map, bar, 64 * i, row);
}

// The 128-row x 128-column tile whose first row is `row`: two 64-column
// boxes.
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row) {
  tma_boxes<2>(dst, map, bar, row, kBoxBytes);
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
// Waits until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_wait_all() { wg_wait<0>(); }

// Pins the accumulator registers in program order around the asynchronous
// wgmma (the compiler sees no dependence between wgmma.wait and them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

#define STEM_ACC32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define STEM_D32 STEM_D8(0), STEM_D8(8), STEM_D8(16), STEM_D8(24)

// d (+)= A.B for a 64 x 64 x 16 step, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " STEM_ACC32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : STEM_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A.B for a 64 x 64 x 16 step, A (bf16 pairs) in registers, B
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " STEM_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : STEM_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define STEM_ACC16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define STEM_D16 STEM_D8(0), STEM_D8(8)

// d (+)= A.B for a 64 x 32 x 16 step, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " STEM_ACC16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : STEM_D16
      : "l"(da), "l"(db), "r"(accumulate));
}

#define STEM_ACC96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, " \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, " \
  "%92, %93, %94, %95}"
#define STEM_D96 STEM_D64, STEM_D8(64), STEM_D8(72), STEM_D8(80), STEM_D8(88)

// d += A.B for a 64 x 192 x 16 step, A in registers, B MN-major.
__device__ __forceinline__ void wgmma_rs192(float (&d)[96], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %101, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " STEM_ACC96
      ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : STEM_D96
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define STEM_ACC128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, " \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, " \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, " \
  "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, " \
  "%119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define STEM_D128 STEM_D96, STEM_D8(96), STEM_D8(104), STEM_D8(112), STEM_D8(120)

// d += A.B for a 64 x 256 x 16 step, A in registers, B MN-major.
__device__ __forceinline__ void wgmma_rs256(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " STEM_ACC128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : STEM_D128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef STEM_D128
#undef STEM_ACC128
#undef STEM_D96
#undef STEM_ACC96
#undef STEM_D32
#undef STEM_ACC32
#undef STEM_D16
#undef STEM_ACC16
#undef STEM_D64
#undef STEM_D8
#undef STEM_ACC64

// The products at a width N: S's m64nNk16 (A, B K-major in shared memory;
// N = BN: 32 only in the backward's dq kernel) and O's (A in registers, B
// MN-major; N = DV).
template <int N>
__device__ __forceinline__ void wgmma_ss_n(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "S is 32, 64 or 128 keys wide");
  if constexpr (N == 128)
    wgmma_ss(d, da, db, accumulate);
  else if constexpr (N == 64)
    wgmma_ss64(d, da, db, accumulate);
  else
    wgmma_ss32(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs_n(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "O is 64-256 columns wide");
  if constexpr (N == 128)
    wgmma_rs(d, a, db);
  else if constexpr (N == 64)
    wgmma_rs64(d, a, db);
  else if constexpr (N == 192)
    wgmma_rs192(d, a, db);
  else
    wgmma_rs256(d, a, db);
}

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

// S = Q.K^T of this warpgroup's 64 rows against the BN keys of a stage.
template <class C = Tile128>
__device__ __forceinline__ void score_tile(float (&s)[C::BN / 2], uint32_t q_addr,
                                           uint32_t k_addr) {
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) s[i] = 0.f;
  fence_regs(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < C::D / 16; ++kk) {
    const uint32_t in_box = (kk & 3) * 32;
    wgmma_ss_n<C::BN>(s, wg_desc(q_addr + (kk >> 2) * C::kQBox + in_box, 16, 1024),
                      wg_desc(k_addr + (kk >> 2) * C::kKVBox + in_box, 16, 1024), kk > 0);
  }
  wg_commit();
  wg_wait_all();
  fence_regs(s);
}

// O += P.V over the BN keys of a stage; p holds P as bf16 A fragments.
template <class C = Tile128>
__device__ __forceinline__ void value_tile(float (&o)[C::DV / 2],
                                           const uint32_t (&p)[C::BN / 16][4], uint32_t v_addr) {
  fence_regs(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < C::BN / 16; ++kk)
    wgmma_rs_n<C::DV>(o, p[kk], wg_desc(v_addr + kk * 16 * 128, C::kKVBox, 1024));
  wg_commit();
  wg_wait_all();
  fence_regs(o);
}

// The producer / consumer pipeline of one CTA at shape C.  `tiles.next(k0,
// off)` yields the row offset k0 (from kv_row) of each C::BN-key tile to
// attend, and off = (token of its key 0) - (token of query row 0): key
// column c is masked from query row r where c + off > r, so a tile with off
// <= -C::BN is wholly visible and takes no mask (flash and block-sparse give
// off = 0 on the diagonal tile, and off = 64 on the tile past it at BN 64;
// the paged chunk lane any offset, for a chunk that starts anywhere).
// Producer and consumers walk their own copies of the same sequence.  q_row
// / kv_row: the first global row of the Q tile and of the KV head in the
// tensor maps; out: the tile's first output row (rows C::DV wide);
// valid_rows: rows of the tile to write; lse (optional): the tile's first
// row of the (natural-log) log-sum-exp output, written for the backward.
template <class C = Tile128, class Tiles>
__device__ __forceinline__ void attend_tile(uint8_t* smem_raw, const CUtensorMap* tq,
                                            const CUtensorMap* tk, const CUtensorMap* tv,
                                            long long q_row, long long kv_row, Tiles tiles,
                                            __nv_bfloat16* out, int valid_rows, float scale,
                                            float* lse = nullptr) {
  constexpr int kStages = C::kStages, BN = C::BN, DV = C::DV;
  typename C::Smem& sm = aligned_smem<typename C::Smem>(smem_raw);
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
      mbar_expect_tx(&sm.q_full, C::kQBytes);
      tma_boxes<C::D / 64>(sm.q, tq, &sm.q_full, static_cast<int>(q_row), C::kQBox);
      int k0, off, it = 0;
      while (tiles.next(k0, off)) {
        const int s = it % kStages;
        mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        const int row = static_cast<int>(kv_row + k0);
        mbar_expect_tx(&sm.full_k[s], C::kKBytes);
        tma_boxes<C::D / 64>(sm.k[s], tk, &sm.full_k[s], row, C::kKVBox);
        mbar_expect_tx(&sm.full_v[s], C::kVBytes);
        tma_boxes<DV / 64>(sm.v[s], tv, &sm.full_v[s], row, C::kKVBox);
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
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_addr = smem_u32(sm.q) + c * 64 * 128;
    mbar_wait(&sm.q_full, 0);

    int k0, off, it = 0;
    while (tiles.next(k0, off)) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const bool masked = off > -BN;
      mbar_wait(&sm.full_k[st], ph);
      float s[BN / 2];
      score_tile<C>(s, q_addr, smem_u32(sm.k[st]));

      // online softmax; a row that has seen no key yet (m = -inf, possible
      // on a partly visible tile) exponentiates against 0, not -inf, so it
      // adds exact zeros instead of NaN
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
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
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[4 * j + 2 * h + e] - m_use);
            s[4 * j + 2 * h + e] = p;
            sum += p;
          }
        l[h] = l[h] * corr + sum;                // this thread's share of the row
        m[h] = m_new;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          o[4 * j + 2 * h] *= corr;
          o[4 * j + 2 * h + 1] *= corr;
        }
      }
      uint32_t p[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      mbar_wait(&sm.full_v[st], ph);
      value_tile<C>(o, p, smem_u32(sm.v[st]));
      mbar_arrive(&sm.empty[st]);
      ++it;
    }

    // finalize: acc / max(l, 1e-20), so a row that attended nothing is 0;
    // its log-sum-exp m ln 2 + ln l (m in log2 units), +inf where l = 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float den = fmaxf(lt, 1e-20f);
      const int r = row0 + 8 * h;
      if (r >= valid_rows) continue;
      if (lse != nullptr && t == 0)
        lse[r] = lt > 0.f ? (m[h] + log2f(lt)) * 0.6931471805599453f : INFINITY;
      __nv_bfloat16* dst = out + static_cast<long long>(r) * DV + 2 * t;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
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

// A (rows, width) bf16 row-major matrix (width a multiple of 64) as a
// tensor map of box_rows x 64-column boxes with the 128-byte swizzle.  base
// must be 16-byte aligned.  The encoding is a driver call: the calling
// thread needs a current context (stem_bwg::on_device binds one for the
// backward, whose thread may be autograd's worker).
inline bool make_map(CUtensorMap* map, const void* base, long long rows, int box_rows = 128,
                     int width = kD) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || rows <= 0 || rows >= (1ll << 31)) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {width * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of shape C: q (b * hq * n rows of C::D, 128-row boxes), k (b * hk
// * n rows of C::D) and v (of C::DV), both in C::BN-row boxes.
template <class C = Tile128>
inline bool make_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv, const void* q,
                      const void* k, const void* v, int b, int hq, int hk, int n) {
  return make_map(tq, q, (long long)b * hq * n, kBM, C::D) &&
         make_map(tk, k, (long long)b * hk * n, C::BN, C::D) &&
         make_map(tv, v, (long long)b * hk * n, C::BN, C::DV);
}

// The order of a prefill grid over (query tile, query head): 1 = the query
// tiles of one head fastest, 0 = the heads fastest.  Heads fastest runs
// the heaviest tiles of every head first (the causal tail holds light
// tiles) and the g heads of a KV head side by side, but a wave then reads
// the keys of every KV head, and each tile is read again by the next wave:
// that hits L2 only while the K / V of all heads fit in it.  Past twice the
// L2 (deepseek-v3-671b's 128 heads at 16k: 1.34 GB) a wave of one head's
// tiles reads each key tile once from memory for all of them.
// kv_bytes: the K and V of every KV head.
inline int tiles_fastest(long long kv_bytes) {
  static const long long l2 = [] {
    int dev = 0, bytes = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrL2CacheSize, dev) != cudaSuccess)
      return 50ll << 20;
    return static_cast<long long>(bytes);
  }();
  return kv_bytes > 2 * l2;
}

template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, size_t smem_bytes = kSmemBytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes));
}

}  // namespace stem_wg
