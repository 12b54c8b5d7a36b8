// The head_dims the kernels are instantiated for.  STEM_HEAD_DIM_SWITCH(d,
// expr) returns expr with the constant D = d for d in the paged kernels'
// set (the Python wrappers' kernels.HEAD_DIMS), and cudaErrorInvalidValue
// for any other head_dim.  STEM_HEAD_DIM_PAIR_SWITCH(d, dv, expr) does the
// same with D = d and DV = dv for the (q/k, v) head_dim pairs of the
// one-shot prefill kernels (kernels.HEAD_DIM_PAIRS): every head_dim of the
// set with v at the same width, and MLA's (24, 16), (24, 24), (192, 128)
// and (192, 192) (the reduced and the published deepseek-v3-671b: its
// attention at q/k 192 and v 128, its MTP layer at 192 throughout).
#pragma once

#include <cuda_runtime.h>

#define STEM_HEAD_DIM_CASE(N, ...) \
  case N: {                        \
    constexpr int D = N;           \
    return __VA_ARGS__;            \
  }

#define STEM_HEAD_DIM_SWITCH(d, ...)          \
  switch (d) {                                \
    STEM_HEAD_DIM_CASE(8, __VA_ARGS__)        \
    STEM_HEAD_DIM_CASE(16, __VA_ARGS__)       \
    STEM_HEAD_DIM_CASE(32, __VA_ARGS__)       \
    STEM_HEAD_DIM_CASE(64, __VA_ARGS__)       \
    STEM_HEAD_DIM_CASE(128, __VA_ARGS__)      \
    STEM_HEAD_DIM_CASE(256, __VA_ARGS__)      \
    default:                                  \
      return (int)cudaErrorInvalidValue;      \
  }

#define STEM_HEAD_DIM_PAIR_CASE(N, NV, ...) \
  case (N) * 1024 + (NV): {                 \
    constexpr int D = N;                    \
    constexpr int DV = NV;                  \
    return __VA_ARGS__;                     \
  }

#define STEM_HEAD_DIM_PAIR_SWITCH(d, dv, ...)                                 \
  if ((d) <= 0 || (d) >= 1024 || (dv) <= 0 || (dv) >= 1024)                 \
    return (int)cudaErrorInvalidValue;                                        \
  switch ((d) * 1024 + (dv)) {                                                \
    STEM_HEAD_DIM_PAIR_CASE(8, 8, __VA_ARGS__)                                \
    STEM_HEAD_DIM_PAIR_CASE(16, 16, __VA_ARGS__)                              \
    STEM_HEAD_DIM_PAIR_CASE(24, 16, __VA_ARGS__)                              \
    STEM_HEAD_DIM_PAIR_CASE(24, 24, __VA_ARGS__)                              \
    STEM_HEAD_DIM_PAIR_CASE(32, 32, __VA_ARGS__)                              \
    STEM_HEAD_DIM_PAIR_CASE(64, 64, __VA_ARGS__)                              \
    STEM_HEAD_DIM_PAIR_CASE(128, 128, __VA_ARGS__)                            \
    STEM_HEAD_DIM_PAIR_CASE(192, 128, __VA_ARGS__)                            \
    STEM_HEAD_DIM_PAIR_CASE(192, 192, __VA_ARGS__)                            \
    STEM_HEAD_DIM_PAIR_CASE(256, 256, __VA_ARGS__)                            \
    default:                                                                  \
      return (int)cudaErrorInvalidValue;                                      \
  }

// STEM_WGMMA_PAIR_SWITCH(d, dv, expr) returns expr with D = d and DV = dv
// for the pairs whose bf16 forward (flash, and block-sparse at a block that
// is a multiple of 128) runs on the tensor-core tile of attn_wgmma.cuh at
// TileOf<D, DV> (kernels.forward_route's table: every q/k width a multiple
// of wgmma's k16 and the tile's 64-column boxes, v at most 256), and falls
// through for any other pair, which runs the CUDA-core tile.
#define STEM_WGMMA_PAIR_CASE(N, NV, ...) STEM_HEAD_DIM_PAIR_CASE(N, NV, __VA_ARGS__)

#define STEM_WGMMA_PAIR_SWITCH(d, dv, ...)                                    \
  if ((d) > 0 && (d) < 1024 && (dv) > 0 && (dv) < 1024) {                    \
    switch ((d) * 1024 + (dv)) {                                              \
      STEM_WGMMA_PAIR_CASE(64, 64, __VA_ARGS__)                               \
      STEM_WGMMA_PAIR_CASE(128, 128, __VA_ARGS__)                             \
      STEM_WGMMA_PAIR_CASE(192, 128, __VA_ARGS__)                             \
      STEM_WGMMA_PAIR_CASE(192, 192, __VA_ARGS__)                             \
      STEM_WGMMA_PAIR_CASE(256, 256, __VA_ARGS__)                             \
      default:                                                                \
        break;                                                                \
    }                                                                         \
  }
