"""MoE layer execution (counterpart of ``repro.parallel.moe_parallel``).

Only the single-device path is ported: ``moe_layer`` with ``mesh=None``
flattens (B, S, D) to tokens and runs the local body of
``hexa_moe_island`` — ``espec.hexa_moe_ffn``: route, expert-sorted
re-index, fused expert FFN (GLU, or 2-MLP with biases), combine. The
layer's parameters are a dict: 'router' plus 'w_gate'/'w_up'/'w_down'
(``MoEStatic.glu``) or 'w1'/'b1'/'w2'/'b2' (the JAX ``MoEParams`` fields).
The mesh islands (model-/data-centric dispatch, hetero masking, EP) belong
to a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import espec
from repro_torch.parallel.sharding import ParallelConfig


class MoEStatic(NamedTuple):
    """Static MoE layer hyperparameters."""
    num_experts: int
    top_k: int
    act: str = "silu"
    glu: bool = True
    norm_topk: bool = True
    softmax_after_topk: bool = False


def hexa_moe_island(x: torch.Tensor, p: dict, ms: MoEStatic,
                    cfg: ParallelConfig):
    """Local tokens x (N, D) -> (y, aux_loss, z_loss)."""
    out = espec.hexa_moe_ffn(
        x, p, num_experts=ms.num_experts, top_k=ms.top_k, act=ms.act,
        glu=ms.glu, blk=cfg.blk, norm_topk=ms.norm_topk,
        softmax_after_topk=ms.softmax_after_topk)
    return out.y, out.aux_loss, out.z_loss


def moe_layer(x: torch.Tensor, p: dict, ms: MoEStatic, cfg: ParallelConfig,
              mesh=None):
    """MoE FFN over a (B, S, D) activation -> (y, aux_loss, z_loss)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh islands are not ported yet (ROADMAP.md)")
    b, s, d = x.shape
    y, aux, z = hexa_moe_island(x.reshape(b * s, d), p, ms, cfg)
    return y.reshape(b, s, d), aux, z
