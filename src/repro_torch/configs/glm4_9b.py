"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552; RoPE, GQA group 16, untied LM head (port of the reference
config)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    activation="silu",
    rope_theta=1e6,
    tie_embeddings=False,
    use_stem=True,
    train_microbatches=4,
)
