"""Gemma-3-12B — dense, 5:1 local:global attention, 128k context.
[hf:google/gemma-3 family]

48L d_model=3840 16H (GQA kv=8, head_dim=256) d_ff=15360 vocab=262144.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    act="gelu",
    glu=True,          # GeGLU
    qk_norm=True,
    embed_scale=True,
    rope_theta=1e6,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    act="gelu",
    glu=True,
    qk_norm=True,
    embed_scale=True,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window=16,
    tie_embeddings=True,
)
