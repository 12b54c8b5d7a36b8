"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280; MLA, 1 shared + 256 routed experts top-8, first 3 layers
dense (d_ff 18432), MTP head (port of the reference config).
[arXiv:2412.19437; hf]

The paper's DeepSeek-V3.2 DSA + Stem experiment: the TPD schedule wraps
block top-k over MLA's expanded keys.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=192,               # nope 128 + rope 64 (MLA)
    d_ff=2048,                  # routed-expert FFN width
    vocab_size=129280,
    activation="silu",
    tie_embeddings=False,
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        expert_d_ff=2048,
        shared_experts=1,
        shared_d_ff=2048,
        first_k_dense=3,
        first_dense_d_ff=18432,
        capacity_factor=1.25,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    mtp=True,
    use_stem=True,
    fsdp_weights=True,
    train_microbatches=8,
)
