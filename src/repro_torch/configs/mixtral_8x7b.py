"""Mixtral-8x7B — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]

32L d_model=4096 32H (GQA kv=8) expert d_ff=14336 vocab=32000, SWA 4096.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=32000,
    act="silu",
    glu=True,
    rope_theta=1e6,
    attn_pattern=("local",),   # SWA on every layer
    window=4096,
    tie_embeddings=False,
    moe=MoEConfig(
        num_experts=8, top_k=2, d_ff=14336,
        norm_topk=False, softmax_after_topk=True,
    ),
)

SMOKE_CONFIG = ModelConfig(
    name="mixtral-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=0,
    vocab_size=128,
    attn_pattern=("local",),
    window=16,
    tie_embeddings=False,
    moe=MoEConfig(
        num_experts=4, top_k=2, d_ff=96,
        norm_topk=False, softmax_after_topk=True,
    ),
)
