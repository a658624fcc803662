"""PaliGemma-3B — SigLIP vision encoder + Gemma-2B decoder.
[arXiv:2407.07726; hf]

Backbone: 18L d_model=2048 8H (MQA kv=1, head_dim=256) d_ff=16384
vocab=257216. The SigLIP frontend is a STUB: input_specs provides 256
precomputed patch embeddings (frontend_dim=1152); the image prefix is
bidirectional (prefix-LM mask, prefix_len=256).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    act="gelu",
    glu=True,
    embed_scale=True,
    rope_theta=1e4,
    frontend="siglip",
    frontend_dim=1152,
    prefix_len=256,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="paligemma-smoke",
    family="vlm",
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
    frontend="siglip",
    frontend_dim=48,
    prefix_len=8,
    tie_embeddings=True,
)
