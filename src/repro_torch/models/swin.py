"""Swin-Transformer-MoE configuration data (counterpart of the config part of
``repro.models.swin``). Only the dataclass the swin configs are built from
is here: the Swin model itself is not ported yet."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.configs.base import MoEConfig


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    name: str
    family: str = "vision-moe"
    img_size: int = 224
    patch_size: int = 4
    in_chans: int = 3
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    moe_stages: Tuple[int, ...] = (2, 3)
    moe: Optional[MoEConfig] = None
    norm_eps: float = 1e-5
    dtype: str = "float32"

    def is_moe_block(self, stage: int, blk: int) -> bool:
        return self.moe is not None and stage in self.moe_stages and blk % 2 == 1


SWIN_SMALL = dict(depths=(2, 2, 18, 2), dims=(96, 192, 384, 768),
                  heads=(3, 6, 12, 24))
SWIN_BASE = dict(depths=(2, 2, 18, 2), dims=(128, 256, 512, 1024),
                 heads=(4, 8, 16, 32))
