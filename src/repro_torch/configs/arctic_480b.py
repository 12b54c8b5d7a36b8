"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000; dense-MoE hybrid: 128 experts top-2 + parallel dense residual
FFN (port of the reference config). [hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    activation="silu",
    tie_embeddings=False,
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        expert_d_ff=4864,
        residual_dense=True,
        residual_d_ff=4864,
    ),
    use_stem=True,
    fsdp_weights=True,
    train_microbatches=8,
)
