"""Qwen3-30B-A3B — fine-grained MoE. [hf:Qwen/Qwen3-30B-A3B; hf]

48L d_model=2048 32H (GQA kv=4, head_dim=128) expert d_ff=768,
vocab=151936, MoE 128 experts top-8, norm_topk, qk-norm.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    act="silu",
    glu=True,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff=768, norm_topk=True),
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=0,
    vocab_size=128,
    qk_norm=True,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=32),
)
