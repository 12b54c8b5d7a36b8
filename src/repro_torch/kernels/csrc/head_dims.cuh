// The head_dims the attention and scorer kernels are instantiated for (the
// Python wrappers' kernels.HEAD_DIMS).  STEM_HEAD_DIM_SWITCH(d, expr)
// returns expr with the constant D = d for d in the set, and
// cudaErrorInvalidValue for any other head_dim.
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
