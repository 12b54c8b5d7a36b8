"""mamba2-370m [ssm] — 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality) (port of the reference config).
[arXiv:2405.21060; unverified]

Stem does not apply (no attention map to sparsify); sub-quadratic by
construction.
"""
from repro_torch.configs.base import ArchConfig, SSDConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=32,               # d_inner / head_dim = 2048 / 64
    num_kv_heads=32,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssd=SSDConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk_size=128),
    use_stem=False,
    sub_quadratic=True,
    train_microbatches=4,
)
