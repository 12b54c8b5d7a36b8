"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""
import torch

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


# The (q/k, v) pairs whose bf16 forward runs on the tensor-core tile
# (csrc/attn_wgmma.cuh, TMA + wgmma, P rounded to bf16 before P.V; listed
# again in csrc/head_dims.cuh STEM_WGMMA_PAIR_SWITCH): q/k widths that are
# multiples of wgmma's k16 and of the tile's 64-column boxes, v at most 256.
# The narrow pairs (8-32, MLA's reduced (24, 16) / (24, 24)) stay on the
# fp32 CUDA-core tile.
WGMMA_PAIRS = ((64, 64), (128, 128), (192, 128), (192, 192), (256, 256))


def forward_route(dtype, d: int, dv: int, block_size=None) -> str:
    """The route of a flash (block_size None) or block-sparse attention
    forward call: "wgmma" (the tensor-core tile, P rounded to bf16) for bf16
    at a pair of ``WGMMA_PAIRS`` and, for block-sparse attention, a block
    that is a multiple of 128 (a CTA owns 128 query rows); "cuda_core"
    (attn_tile.cuh's fp32 products and probabilities) for fp32 and every
    other pair and block.  The .cu dispatch mirrors it."""
    wgmma = (dtype == torch.bfloat16 and (d, dv) in WGMMA_PAIRS
             and (block_size is None or block_size % 128 == 0))
    return "wgmma" if wgmma else "cuda_core"


def wgmma_counter(kernel: str, d: int, dv: int) -> str:
    """The launch counter of ``kernel``'s tensor-core instance at (d, dv)."""
    return f"{kernel}_wgmma_{d}x{dv}"


def backward_route(dtype, d: int, dv: int, block_size=None) -> str:
    """The route of the attention backward kernels: "wgmma" (TMA + wgmma,
    P and dS rounded to bf16) for bf16 at q/k = v head_dim 128 and, for
    block-sparse attention, a block that is a multiple of 128; "cuda_core"
    (attn_bwd.cuh's fp32 tiles, fed the lse of whichever forward ran) for
    every other dtype, head_dim pair and block."""
    wgmma = (dtype == torch.bfloat16 and d == dv == 128
             and (block_size is None or block_size % 128 == 0))
    return "wgmma" if wgmma else "cuda_core"
