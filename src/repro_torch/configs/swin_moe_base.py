"""Swin-MoE-Base — the paper's benchmark (larger scale)."""
from repro_torch.configs.base import MoEConfig
from repro_torch.configs.swin_moe_small import with_experts  # re-export helper
from repro_torch.models.swin import SWIN_BASE, SwinConfig

CONFIG = SwinConfig(
    name="swin-moe-base",
    moe=MoEConfig(num_experts=8, top_k=1, d_ff=0, norm_topk=True),
    **SWIN_BASE,
)

SMOKE_CONFIG = SwinConfig(
    name="swin-moe-base-smoke",
    img_size=32,
    patch_size=4,
    depths=(1, 1, 2, 1),
    dims=(32, 64, 128, 256),
    heads=(2, 4, 4, 8),
    window=2,
    num_classes=10,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=0),
)
