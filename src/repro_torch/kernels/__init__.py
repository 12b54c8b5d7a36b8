"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""

# The head_dims the paged kernels (the scorer, page attention) are built for,
# each a template instance listed again in csrc/head_dims.cuh; the wrappers
# raise on any other.
HEAD_DIMS = (8, 16, 32, 64, 128, 256)

# The (q/k, v) head_dim pairs the one-shot prefill kernels (flash and
# block-sparse attention) are built for (csrc/head_dims.cuh
# STEM_HEAD_DIM_PAIR_SWITCH): every head_dim above with v at the same width,
# and MLA's: the reduced deepseek-v3-671b's (24, 16) and its MTP layer's
# (24, 24), the published config's (192, 128) and its MTP layer's (192, 192).
HEAD_DIM_PAIRS = tuple(sorted({(d, d) for d in HEAD_DIMS}
                              | {(24, 16), (24, 24), (192, 128), (192, 192)}))


def check_head_dim_pair(name: str, d: int, dv: int) -> None:
    """Raises ValueError unless (d, dv) is a pair the prefill kernels are
    built for."""
    if (d, dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"{name}: (q/k head_dim, v head_dim) = ({d}, {dv}) must be "
                         f"one of {HEAD_DIM_PAIRS}")
