"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000; RG-LRU + local attention 1:2 (griffin) (port of the
reference config).  [arXiv:2402.19427; hf]

Sub-quadratic: the RG-LRU recurrence and 2048-token windowed local
attention.  Stem does not apply to the RG-LRU layers and is degenerate for
the windowed ones.
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    activation="gelu",
    tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4, attn_period=3, window=2048),
    use_stem=False,
    sub_quadratic=True,
    train_microbatches=4,
)
