"""Gemma-2B — dense, GeGLU, MQA (kv=1), head_dim=256. [arXiv:2403.08295; hf]

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    act="gelu",
    glu=True,          # GeGLU
    embed_scale=True,
    rope_theta=1e4,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma2b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    act="gelu",
    glu=True,
    embed_scale=True,
    tie_embeddings=True,
)
