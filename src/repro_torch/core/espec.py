"""Layer-level expert-specific MoE computation (paper Fig. 3; counterpart
of ``repro.core.espec``).

route -> build_reindex -> fused expert FFN (gather, up/gate, act, down,
gate) -> scatter-add combine, with zero computation redundancy: no
capacity factor, no token drop, at most BLK-1 pad rows per expert. Two
expert bodies, each fused (``kernels.ops.esffn_glu`` / ``esffn_mlp``, the
default, as for the JAX package's TPU path) or staged through the
differentiable ESMM (``fused=False``); autodiff flows through either op's
backward:

* ``moe_mlp`` — the paper's 2-MLP expert with biases (Swin-MoE);
* ``moe_glu`` — gate/up/down GLU experts (Mixtral / Qwen3).

Quantized expert weights (int8/fp8 payloads with ``<name>_scale`` block
scales, ``quant.core.quantize_ffn``) pass their scales to the same ops,
fused or staged, and are frozen in the backward.
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


def moe_mlp(x: torch.Tensor, ri: ReIndex, w1, b1, w2, b2, *, scales=None,
            act: str = "gelu", fused: bool = True) -> torch.Tensor:
    """Paper-form 2-MLP expert FFN y = act(x W1 + b1) W2 + b2, routed per
    token, over a flat token batch x: (N, D); b1/b2 may be None.
    ``scales``: (s1, s2) of int8/fp8 w1 and w2."""
    if fused:
        ys = ops.esffn_mlp(x, ri.row_token, ri.row_gate, ri.block_expert,
                           ri.padded_counts, w1, b1, w2, b2, scales=scales,
                           act=act)
        return scatter_rows(ys, ri.row_token, x.shape[0])
    s1, s2 = scales if scales is not None else (None, None)
    xs = gather_sorted(x, ri)
    h = ops.esmm(xs, w1, b1, ri.block_expert, ri.padded_counts, w_scales=s1)
    h = ACTIVATIONS[act](h)
    ys = ops.esmm(h, w2, b2, ri.block_expert, ri.padded_counts, w_scales=s2)
    return combine_scatter(ys, ri, x.shape[0])


def moe_glu(x: torch.Tensor, ri: ReIndex, w_gate, w_up, w_down, *,
            scales=None, act: str = "silu",
            fused: bool = True) -> torch.Tensor:
    """GLU expert FFN y = (act(x Wg) * (x Wu)) Wd, routed per token, over a
    flat token batch x: (N, D). ``scales``: (sg, su, sd) of int8/fp8
    weights."""
    if fused:
        ys = ops.esffn_glu(x, ri.row_token, ri.row_gate, ri.block_expert,
                           ri.padded_counts, w_gate, w_up, w_down,
                           scales=scales, act=act)
        return scatter_rows(ys, ri.row_token, x.shape[0])
    sg, su, sd = scales if scales is not None else (None,) * 3
    xs = gather_sorted(x, ri)
    g = ops.esmm(xs, w_gate, None, ri.block_expert, ri.padded_counts,
                 w_scales=sg)
    u = ops.esmm(xs, w_up, None, ri.block_expert, ri.padded_counts,
                 w_scales=su)
    h = ACTIVATIONS[act](g) * u
    ys = ops.esmm(h, w_down, None, ri.block_expert, ri.padded_counts,
                  w_scales=sd)
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
    x: (N, D); params holds 'router' (D, E) plus either 'w_gate', 'w_up',
    'w_down' (glu) or 'w1', 'b1', 'w2', 'b2' (mlp; the biases may be
    absent). Quantized expert weights carry their block scales as
    '<name>_scale' entries (``quant.core.quantize_ffn``), detected here."""
    r = route(x, params["router"], top_k, norm_topk=norm_topk,
              softmax_after_topk=softmax_after_topk)
    ri = build_reindex(r.expert_idx, r.gates, num_experts, blk)
    if glu:
        scales = None
        if "w_gate_scale" in params:
            scales = (params["w_gate_scale"], params["w_up_scale"],
                      params["w_down_scale"])
        y = moe_glu(x, ri, params["w_gate"], params["w_up"],
                    params["w_down"], scales=scales, act=act)
    else:
        scales = None
        if "w1_scale" in params:
            scales = (params["w1_scale"], params["w2_scale"])
        y = moe_mlp(x, ri, params["w1"], params.get("b1"), params["w2"],
                    params.get("b2"), scales=scales, act=act)
    return MoEOutput(y=y, aux_loss=r.aux_loss, z_loss=r.z_loss, router=r)
