"""Jamba-1.5-Large (398B) — Mamba+attention 7:1 hybrid with MoE.
[arXiv:2403.19887; hf]

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2 on
every other layer; attention once per 8-layer period (no RoPE in Jamba).
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    act="silu",
    glu=True,
    use_rope=False,
    tie_embeddings=False,
    layer_pattern=(
        "mamba", "mamba", "mamba", "mamba",
        "attn", "mamba", "mamba", "mamba",
    ),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576, period=2, offset=1),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=512, chunk=128),
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    use_rope=False,
    tie_embeddings=False,
    layer_pattern=(
        "mamba", "mamba", "mamba", "mamba",
        "attn", "mamba", "mamba", "mamba",
    ),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=96, period=2, offset=1),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2, dt_rank=8, chunk=8),
)
