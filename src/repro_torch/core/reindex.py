"""Re-index vector construction (paper §4.2, Algorithm 1; counterpart of
``repro.core.reindex``).

One stable sort by expert lays the token copies out expert-sorted, every
BLK-row block owned by exactly one expert (groups padded to BLK with
sentinel rows). All shapes are static, Np = round_up(N*k + E*(BLK-1), BLK),
and nothing here waits on the device: counts come from a scatter-add, not
``bincount``, which would read its maximum back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common import round_up

DEFAULT_BLK = 128


class ReIndex(NamedTuple):
    """Static-shape expert-sorted layout descriptor (all int32 but the gate).

    row_id (Np,): flat copy id (token*k + slot), or the sentinel N*k.
    row_token (Np,): source token id, or the sentinel N for padding.
    row_gate (Np,) f32: combine gate, 0 for padding rows.
    block_expert (Np//BLK,): expert owning each BLK-row block.
    counts / padded_counts (E,): copies per expert, and rounded up to BLK.
    """
    row_id: torch.Tensor
    row_token: torch.Tensor
    row_gate: torch.Tensor
    block_expert: torch.Tensor
    counts: torch.Tensor
    padded_counts: torch.Tensor

    @property
    def num_rows(self) -> int:
        return self.row_id.shape[0]


def padded_rows(n: int, k: int, num_experts: int, blk: int = DEFAULT_BLK) -> int:
    """Static worst-case number of rows in the sorted layout."""
    return round_up(n * k + num_experts * (blk - 1), blk)


def build_reindex(
    expert_idx: torch.Tensor,
    gates: torch.Tensor,
    num_experts: int,
    blk: int = DEFAULT_BLK,
) -> ReIndex:
    """Expert-sorted block-padded layout from routing decisions
    (expert_idx, gates: (N, k))."""
    n, k = expert_idx.shape
    nk = n * k
    np_rows = padded_rows(n, k, num_experts, blk)
    dev = expert_idx.device
    i64 = dict(dtype=torch.int64, device=dev)

    e_flat = expert_idx.reshape(nk).long()
    g_flat = gates.reshape(nk).float()
    counts = torch.zeros(num_experts, **i64).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    padded_counts = (counts + blk - 1) // blk * blk
    zero = torch.zeros(1, **i64)
    # group e spans [p_offset[e], p_offset[e] + padded_counts[e])
    p_offset = torch.cat([zero, torch.cumsum(padded_counts, 0)])
    u_offset = torch.cat([zero, torch.cumsum(counts, 0)])

    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    rank = torch.arange(nk, **i64) - u_offset[e_sorted]
    dest = p_offset[e_sorted] + rank

    row_id = torch.full((np_rows,), nk, **i64)
    row_id[dest] = order
    row_token = torch.where(row_id == nk, n, row_id // k)
    row_gate = torch.cat([g_flat, g_flat.new_zeros(1)])[row_id]

    # Tail blocks past the last group clamp to E-1; their rows are all
    # sentinels.
    starts = torch.arange(np_rows // blk, **i64) * blk
    block_expert = torch.searchsorted(p_offset, starts, right=True) - 1
    block_expert = block_expert.clamp(0, num_experts - 1)

    i32 = torch.int32
    return ReIndex(
        row_id=row_id.to(i32),
        row_token=row_token.to(i32),
        row_gate=row_gate,
        block_expert=block_expert.to(i32),
        counts=counts.to(i32),
        padded_counts=padded_counts.to(i32),
    )


def gather_rows(x: torch.Tensor, row_token: torch.Tensor) -> torch.Tensor:
    """(Np, D) sorted rows from (N, D) tokens; sentinel rows (== N) gather
    an appended all-zero row."""
    xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
    return xp[row_token.long()]


def gather_sorted(x: torch.Tensor, ri: ReIndex) -> torch.Tensor:
    """``gather_rows`` driven by a full ReIndex descriptor."""
    return gather_rows(x, ri.row_token)


def combine_scatter(ys: torch.Tensor, ri: ReIndex, num_tokens: int) -> torch.Tensor:
    """Gate-weighted scatter-add combine: (Np, D) sorted rows -> (N, D)."""
    vals = ys * ri.row_gate[:, None].to(ys.dtype)
    return scatter_rows(vals, ri.row_token, num_tokens)


def scatter_rows(ys: torch.Tensor, row_token: torch.Tensor,
                 num_tokens: int) -> torch.Tensor:
    """Scatter-add already gate-weighted sorted rows back to token order;
    sentinel rows land in a dropped extra row."""
    out = ys.new_zeros(num_tokens + 1, ys.shape[1])
    out.index_add_(0, row_token.long(), ys)
    return out[:num_tokens]
