"""MusicGen-Large — decoder-only over EnCodec tokens with T5 cross-attention.
[arXiv:2306.05284; hf]

48L d_model=2048 32H (MHA kv=32, head_dim=64) d_ff=8192 vocab=2048 (EnCodec
codebook size), 4 codebooks. The EnCodec frontend is a STUB: input_specs
provides precomputed frame embeddings (frontend_dim=128, the EnCodec latent
dim); the T5 conditioning sequence is likewise precomputed (cross_d=1024).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    glu=False,
    norm="layernorm",
    rope_theta=1e4,
    frontend="encodec",
    frontend_dim=128,
    cross_attn=True,
    cross_d=1024,
    num_codebooks=4,
    tie_embeddings=False,
)

SMOKE_CONFIG = ModelConfig(
    name="musicgen-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=64,
    act="gelu",
    glu=False,
    norm="layernorm",
    frontend="encodec",
    frontend_dim=32,
    cross_attn=True,
    cross_d=48,
    num_codebooks=4,
    tie_embeddings=False,
)
