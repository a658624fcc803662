"""Jamba-1.5-Large (398B) — Mamba+attention 7:1 hybrid with MoE.
[arXiv:2403.19887; hf]

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2 on
every other layer; attention once per 8-layer period (no RoPE in Jamba).
"""
import dataclasses

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

#: Widths at which one 8-layer period of CONFIG trains on one 80 GB card
#: (a full-width period is 45.2 B parameters, 16 bytes each under AdamW
#: with f32 masters): "reference", f32 card-vs-CPU checks (about 0.9 B
#: parameters); "train", bf16 training (3.02 B). Heads stay 128 wide;
#: ``ffn`` is both the dense and the expert d_ff.
CUT_WIDTHS = {
    "reference": dict(d_model=2048, heads=16, kv_heads=2, d_inner=4096,
                      dt_rank=128, ffn=1024),
    "train": dict(d_model=4096, heads=32, kv_heads=4, d_inner=8192,
                  dt_rank=256, ffn=2048),
}


def cut_config(width: str, dtype: str) -> ModelConfig:
    """CONFIG's layout (one period: 7 Mamba layers and 1 attention layer,
    16 experts top-2 on the odd layers, dense GLU FFNs on the even ones,
    d_state 16, chunk 128, vocab 65,536) at ``CUT_WIDTHS[width]``."""
    w = CUT_WIDTHS[width]
    return dataclasses.replace(
        CONFIG, num_layers=len(CONFIG.layer_pattern), d_model=w["d_model"],
        num_heads=w["heads"], num_kv_heads=w["kv_heads"], d_ff=w["ffn"],
        moe=dataclasses.replace(CONFIG.moe, d_ff=w["ffn"]),
        mamba=dataclasses.replace(CONFIG.mamba,
                                  expand=w["d_inner"] // w["d_model"],
                                  dt_rank=w["dt_rank"]), dtype=dtype)


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
