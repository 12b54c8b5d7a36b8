"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000; GeGLU, head_dim=256, sqrt(d) embedding scale (port of the
reference config)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="gelu",
    tie_embeddings=True,
    embed_scale=True,
    use_stem=True,
    train_microbatches=4,
)
