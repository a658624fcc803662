"""Layer-level expert-specific MoE computation (paper Fig. 3; counterpart
of ``repro.core.espec``).

route -> build_reindex -> fused expert FFN (gather, up/gate, act, down,
gate) -> scatter-add combine, with zero computation redundancy: no
capacity factor, no token drop, at most BLK-1 pad rows per expert. GLU
experts only: fused (``kernels.ops.esffn_glu``, the default, as for the
JAX package's TPU path) or staged through the differentiable ESMM
(``fused=False``); autodiff flows through either op's backward.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common import ACTIVATIONS
from repro_torch.core.reindex import (
    ReIndex,
    build_reindex,
    combine_scatter,
    gather_sorted,
    scatter_rows,
)
from repro_torch.core.routing import RouterOutput, route
from repro_torch.kernels import ops


def moe_glu(x: torch.Tensor, ri: ReIndex, w_gate, w_up, w_down, *,
            scales=None, act: str = "silu",
            fused: bool = True) -> torch.Tensor:
    """GLU expert FFN y = (act(x Wg) * (x Wu)) Wd, routed per token, over a
    flat token batch x: (N, D)."""
    if fused:
        ys = ops.esffn_glu(x, ri.row_token, ri.row_gate, ri.block_expert,
                           ri.padded_counts, w_gate, w_up, w_down,
                           scales=scales, act=act)
        return scatter_rows(ys, ri.row_token, x.shape[0])
    if scales is not None:
        raise NotImplementedError(
            "quantized expert weights (w_scales) are not ported yet "
            "(ROADMAP.md: quantization slice)")
    xs = gather_sorted(x, ri)
    g = ops.esmm(xs, w_gate, None, ri.block_expert, ri.padded_counts)
    u = ops.esmm(xs, w_up, None, ri.block_expert, ri.padded_counts)
    h = ACTIVATIONS[act](g) * u
    ys = ops.esmm(h, w_down, None, ri.block_expert, ri.padded_counts)
    return combine_scatter(ys, ri, x.shape[0])


class MoEOutput(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor
    z_loss: torch.Tensor
    router: RouterOutput


def hexa_moe_ffn(x: torch.Tensor, params: dict, *, num_experts: int,
                 top_k: int, act: str, glu: bool, blk: int = 128,
                 norm_topk: bool = True,
                 softmax_after_topk: bool = False) -> MoEOutput:
    """Complete Hexa-MoE FFN: routing + expert-specific computation.
    x: (N, D); params holds 'router' (D, E) and 'w_gate', 'w_up', 'w_down'."""
    if not glu:
        raise NotImplementedError(
            "MLP experts (esffn_mlp) are not ported yet (ROADMAP.md)")
    r = route(x, params["router"], top_k, norm_topk=norm_topk,
              softmax_after_topk=softmax_after_topk)
    ri = build_reindex(r.expert_idx, r.gates, num_experts, blk)
    y = moe_glu(x, ri, params["w_gate"], params["w_up"], params["w_down"],
                act=act)
    return MoEOutput(y=y, aux_loss=r.aux_loss, z_loss=r.z_loss, router=r)
