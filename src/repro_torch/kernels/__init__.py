"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""

# The head_dims the attention and scorer kernels are built for (each a
# template instance, listed again in csrc/head_dims.cuh); the wrappers raise
# on any other.
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
