"""Parallel configuration and initializers (counterpart of the parts of
``repro.parallel.sharding`` the ported slices need). The port runs on one
device, so only the expert-sorted layout's block size, the training
forward's rematerialisation, the Tutel baseline's capacity factor and
quantization-aware training are configurable."""
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
    capacity and ignores it.
    quant: "none" | "int8" | "fp8": quantization-aware training, each
    expert weight passed through ``quant.core.fake_quant`` inside the MoE
    island (straight-through grads; routers and biases untouched). Skipped
    where the params already hold 8-bit payloads with '<name>_scale'
    leaves, which go to the kernels' 8-bit branches instead.
    quant_tile: the block size of those per-(expert, tile) scales."""
    blk: int = 128
    remat: str = "block"          # none | block
    capacity_factor: float = 1.25
    quant: str = "none"           # expert-weight QAT: none | int8 | fp8
    quant_tile: int = 128

    def __post_init__(self):
        if self.remat not in ("none", "block"):
            raise ValueError(f"remat {self.remat!r}: none | block")
        if self.quant not in ("none", "int8", "fp8"):
            raise ValueError(f"quant {self.quant!r}: none | int8 | fp8")
        if self.quant_tile < 1:
            raise ValueError(f"quant_tile {self.quant_tile} < 1")


def normal_init(shape, dtype: torch.dtype, generator: torch.Generator,
                device, scale: float = 0.02) -> torch.Tensor:
    """Scaled normal init: an f32 draw from ``generator``, cast to dtype."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, scale, generator=generator)
    return w.to(dtype)
