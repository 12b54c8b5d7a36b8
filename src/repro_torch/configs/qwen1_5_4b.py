"""qwen1.5-4b [dense] — 40L d_model=2560 20H (MHA kv=20) d_ff=6912
vocab=151936; QKV bias, untied LM head (port of the reference config)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    activation="silu",
    qkv_bias=True,
    tie_embeddings=False,
    use_stem=True,
    fsdp_weights=True,
    train_microbatches=8,
)
