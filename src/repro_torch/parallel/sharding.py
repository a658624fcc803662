"""Parallel configuration and initializers (counterpart of the parts of
``repro.parallel.sharding`` the ported slices need). The port runs on one
device, so only the expert-sorted layout's block size, the training
forward's rematerialisation and the Tutel baseline's capacity factor are
configurable."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """blk: rows per single-expert block of the expert-sorted layout.
    remat: "block" recomputes each block's forward in the training
    backward (``torch.utils.checkpoint``; only the block inputs are
    saved), "none" saves every activation. Serving forwards ignore it.
    capacity_factor: the capacity of ``moe_impl="tutel"``
    (``core.baselines.dispatch_combine_moe``); the Hexa-MoE path has no
    capacity and ignores it."""
    blk: int = 128
    remat: str = "block"          # none | block
    capacity_factor: float = 1.25

    def __post_init__(self):
        if self.remat not in ("none", "block"):
            raise ValueError(f"remat {self.remat!r}: none | block")


def normal_init(shape, dtype: torch.dtype, generator: torch.Generator,
                device, scale: float = 0.02) -> torch.Tensor:
    """Scaled normal init: an f32 draw from ``generator``, cast to dtype."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, scale, generator=generator)
    return w.to(dtype)
