"""Swin-MoE-Small — the paper's benchmark (Tutel configuration).

Swin-S backbone (depths 2/2/18/2, dims 96..768, window 7) with MoE FFN on
alternating blocks of stages 3-4. Expert count / top-k are overridden per
benchmark table (8 experts for Table 7, 4 for Table 8).
"""
import dataclasses

from repro_torch.configs.base import MoEConfig
from repro_torch.models.swin import SWIN_SMALL, SwinConfig

CONFIG = SwinConfig(
    name="swin-moe-small",
    moe=MoEConfig(num_experts=8, top_k=1, d_ff=0, norm_topk=True),
    **SWIN_SMALL,
)

SMOKE_CONFIG = SwinConfig(
    name="swin-moe-small-smoke",
    img_size=32,
    patch_size=4,
    depths=(1, 1, 2, 1),
    dims=(16, 32, 64, 128),
    heads=(2, 2, 4, 4),
    window=2,
    num_classes=10,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=0),
)


def with_experts(cfg: SwinConfig, num_experts: int, top_k: int) -> SwinConfig:
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, num_experts=num_experts, top_k=top_k)
    )
