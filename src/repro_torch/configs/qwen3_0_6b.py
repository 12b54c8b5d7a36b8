"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936; qk_norm, GQA, head_dim=128 (port of the reference config)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    activation="silu",
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    use_stem=True,
    train_microbatches=4,
)
