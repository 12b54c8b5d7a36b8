"""whisper-medium [audio] — 24L(+24 enc) d_model=1024 16H d_ff=4096
vocab=51865; encoder-decoder, the conv frontend a stub (callers pass
precomputed frame embeddings) (port of the reference config).
[arXiv:2212.04356; unverified]

Stem applies to the decoder's self-attention only: the encoder is
bidirectional, with no causal-flow asymmetry.
"""
from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    activation="gelu_mlp",
    norm="layer",
    tie_embeddings=True,
    encdec=EncDecConfig(encoder_layers=24, encoder_frames=1500),
    use_stem=True,
    train_microbatches=4,
)
