"""Parallel configuration and initializers (counterpart of the parts of
``repro.parallel.sharding`` the serving slice needs). The port runs on one
device, so only the expert-sorted layout's block size is configurable."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """blk: rows per single-expert block of the expert-sorted layout."""
    blk: int = 128


def normal_init(shape, dtype: torch.dtype, generator: torch.Generator,
                device, scale: float = 0.02) -> torch.Tensor:
    """Scaled normal init: an f32 draw from ``generator``, cast to dtype."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, scale, generator=generator)
    return w.to(dtype)
