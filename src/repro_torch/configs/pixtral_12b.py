"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT frontend a stub + mistral-nemo-style decoder
backbone (port of the reference config).
[hf:mistralai/Pixtral-12B-2409; unverified]

The vision tower is a stub: callers pass precomputed patch embeddings that
take the first positions of the sequence; the loss is computed on the text
positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    activation="silu",
    rope_theta=1e6,
    tie_embeddings=False,
    vlm_stub=True,
    use_stem=True,
    fsdp_weights=True,
    train_microbatches=4,
)
