"""The MoE execution paths the paper compares against (counterpart of
``repro.core.baselines``; its distributed ``ep_all_to_all`` helpers belong
to the mesh slice and are not ported).

* ``dispatch_combine_moe`` — Tutel-style: token copies are dispatched into a
  dense (E, C, D) capacity buffer (padding and dropping), the experts run
  as batched dense GEMMs over the whole buffer, and the outputs are
  combined back. Capacity padding is computed like real tokens, and copies
  past the capacity are dropped: the redundancy Hexa-MoE removes.
* ``grouped_dense_moe`` — MegaBlocks(MoE)-style: the same buffer with the
  worst-case capacity N*k, so nothing drops and most rows are padding.

Both are plain PyTorch by design, as the JAX package computes them with
``einsum`` outside any Pallas kernel: ``torch.bmm`` on the buffer (cuBLAS
on the card) is the dense-GEMM system the paper measures against. Both
consume the same ``RouterOutput`` as the Hexa-MoE path, so they agree with
it exactly where nothing drops.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.common import cdiv
from repro_torch.core.routing import RouterOutput


def tutel_capacity(n: int, k: int, num_experts: int,
                   capacity_factor: float) -> int:
    """Tutel's capacity: ``int(cdiv(n*k, E) * capacity_factor)``, at least
    1 (an integer ceil, a float product, then a floor, as the JAX package
    takes it)."""
    return max(int(cdiv(n * k, num_experts) * capacity_factor), 1)


def _dispatch_ranks(expert_idx: torch.Tensor, num_experts: int):
    """Position of each token copy in its expert's queue, copies in flat
    (token, slot) order: (rank (N, k) int32, counts (E,) int32). The
    counts come from a scatter-add, which (unlike ``bincount``) reads
    nothing back to the host."""
    n, k = expert_idx.shape
    e_flat = expert_idx.reshape(-1).long()
    order = torch.sort(e_flat, stable=True).indices
    counts = torch.zeros(num_experts, dtype=torch.int64,
                         device=e_flat.device).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    offset = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    rank_sorted = torch.arange(n * k, device=e_flat.device) \
        - offset[e_flat[order]]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return rank.reshape(n, k).to(torch.int32), counts.to(torch.int32)


def dispatch_combine_moe(
    x: torch.Tensor,
    r: RouterOutput,
    w1: torch.Tensor,
    b1: Optional[torch.Tensor],
    w2: torch.Tensor,
    b2: Optional[torch.Tensor],
    *,
    act: Callable,
    capacity_factor: float = 1.25,
    capacity: Optional[int] = None,
    glu_up: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Tutel-like dense dispatch/combine MoE FFN over flat tokens x (N, D).

    C = ``tutel_capacity(N, k, E, capacity_factor)`` unless given; copies
    ranked at C or past it are DROPPED (their gate counts 0), the rest are
    padded into a dense (E, C, D) buffer that the experts compute whole.
    ``glu_up`` (E, D, F) makes the expert act(x W1 + b1) * (x U) first."""
    n, d = x.shape
    e = w1.shape[0]
    k = r.expert_idx.shape[1]
    if capacity is None:
        capacity = tutel_capacity(n, k, e, capacity_factor)
    rows = e * capacity

    rank, _ = _dispatch_ranks(r.expert_idx, e)
    keep = rank < capacity                                      # (N, k)
    # dispatch: a dropped copy goes to one junk row past the buffer (the
    # JAX scatter's out-of-range slot, mode="drop"), sliced off after
    flat_slot = torch.where(keep, r.expert_idx.long() * capacity + rank,
                            rows).reshape(-1)
    src = x[:, None, :].expand(n, k, d).reshape(n * k, d)
    buf = x.new_zeros((rows + 1, d)).index_copy(0, flat_slot, src)
    buf = buf[:rows].reshape(e, capacity, d)

    # the experts as dense batched GEMMs: the padding is computed too
    h = torch.bmm(buf, w1.to(x.dtype))
    if b1 is not None:
        h = h + b1[:, None].to(x.dtype)
    if glu_up is not None:
        h = act(h) * torch.bmm(buf, glu_up.to(x.dtype))
    else:
        h = act(h)
    y = torch.bmm(h, w2.to(x.dtype))
    if b2 is not None:
        y = y + b2[:, None].to(x.dtype)

    # combine: each copy's row (a dropped one reads the buffer's last row,
    # clamped as a JAX gather clamps) weighted by its gate times keep
    got = y.reshape(rows, d)[flat_slot.clamp(max=rows - 1)].reshape(n, k, d)
    gates = (r.gates * keep.to(r.gates.dtype))[..., None].to(x.dtype)
    return torch.sum(got * gates, dim=1)


def grouped_dense_moe(
    x: torch.Tensor,
    r: RouterOutput,
    w1: torch.Tensor,
    b1: Optional[torch.Tensor],
    w2: torch.Tensor,
    b2: Optional[torch.Tensor],
    *,
    act: Callable,
    glu_up: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MegaBlocks(MoE)-like: capacity = the worst case N*k (every copy to
    one expert), so nothing drops and the buffer is E*N*k rows: the
    static-shape analogue of a per-step max-group capacity."""
    n, k = r.expert_idx.shape
    return dispatch_combine_moe(x, r, w1, b1, w2, b2, act=act,
                                capacity=n * k, glu_up=glu_up)
