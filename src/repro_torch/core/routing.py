"""Top-k expert routing (counterpart of ``repro.core.routing``).

Training jitter (``noise_rng``) is not ported: the training step routes
without it (``launch.steps.make_loss_fn`` passes no rng, as the JAX
package's does).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class RouterOutput(NamedTuple):
    expert_idx: torch.Tensor  # (N, k) int32 — chosen expert per slot
    gates: torch.Tensor       # (N, k) float32 — combine weights
    aux_loss: torch.Tensor    # scalar — load-balancing auxiliary loss
    z_loss: torch.Tensor      # scalar — router z-loss
    probs: torch.Tensor       # (N, E) float32 — full router probabilities


def _top_k(v: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index. A stable descending sort keeps equal values in index
    order, which ``torch.topk`` does not promise."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(
    x: torch.Tensor,
    router_w: torch.Tensor,
    k: int,
    *,
    norm_topk: bool = True,
    softmax_after_topk: bool = False,
    valid_mask: Optional[torch.Tensor] = None,
) -> RouterOutput:
    """Top-k routing for a flat token batch x: (N, D) with router_w: (D, E).

    ``norm_topk`` renormalises the top-k probabilities to sum to 1
    (Qwen-style); ``softmax_after_topk`` takes the softmax over the selected
    logits only (Mixtral-style). ``valid_mask`` (N,) bool gives invalid rows
    gate 0 and leaves them out of the aux/z losses."""
    e = router_w.shape[-1]
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    if softmax_after_topk:
        top_logits, expert_idx = _top_k(logits, k)
        gates = torch.softmax(top_logits, dim=-1)
    else:
        gates, expert_idx = _top_k(probs, k)
        if norm_topk:
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # Switch-Transformer load-balance loss: E * sum_e f_e * P_e.
    one_hot = F.one_hot(expert_idx, e).float()                  # (N, k, E)
    lse2 = torch.logsumexp(logits, dim=-1) ** 2
    if valid_mask is None:
        f_e = one_hot.sum(1).mean(0) / k
        p_e = probs.mean(0)
        z_loss = lse2.mean()
    else:
        vm = valid_mask.float()
        gates = gates * vm[:, None]
        denom = torch.clamp(vm.sum(), min=1.0)
        f_e = (one_hot.sum(1) * vm[:, None]).sum(0) / denom / k
        p_e = (probs * vm[:, None]).sum(0) / denom
        z_loss = (lse2 * vm).sum() / denom
    aux_loss = e * torch.sum(f_e * p_e)
    return RouterOutput(
        expert_idx=expert_idx.to(torch.int32),
        gates=gates.float(),
        aux_loss=aux_loss,
        z_loss=z_loss,
        probs=probs,
    )
