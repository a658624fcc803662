"""On-device router and expert telemetry (counterpart of
``repro.obs.device``; DESIGN.md §12).

``expert_stats`` computes, inside the MoE islands, the per-expert
token-slot counts, capacity-overflow drops and gate-entropy sums that the
observability layer publishes, as plain extra step outputs: turning them
on (``ParallelConfig.collect_router_stats``) changes a step's return
arity but adds no host synchronisation. It is plain PyTorch (an int32
``scatter_add_`` and an entropy sum), as the JAX package's is plain
``jnp``, on every device. The counts are exact integers: a host recount
of the same routing decisions (``np.bincount`` over ``expert_idx``)
matches bitwise, and so do the JAX package's counts.

``RouterStatsDrain`` is the host side: ``push`` keeps references to the
device tensors (the card runs ahead; nothing is copied or waited for),
and ``flush``, called at metrics-dump boundaries and never in the step's
hot path, copies everything pending to the host in one transfer a key
and folds it into the metrics registry in push order. Every step's stats
are fresh tensors (``add_stats`` allocates), so a tensor the drain holds
is never written again.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

STAT_KEYS = ("expert_tokens", "dropped_tokens", "entropy_sum", "tokens")


def zero_stats(num_experts: int, device=None) -> Dict[str, torch.Tensor]:
    """The all-zero stats (the layer-sum start; a dense stack's filler)."""
    z = torch.zeros((), dtype=torch.int32, device=device)
    return {
        "expert_tokens": torch.zeros((num_experts,), dtype=torch.int32,
                                     device=device),
        "dropped_tokens": z,
        "entropy_sum": torch.zeros((), dtype=torch.float32, device=device),
        "tokens": z.clone(),
    }


def add_stats(a: Dict[str, torch.Tensor],
              b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Elementwise sum of two stats dicts into fresh tensors (the layer
    and token accumulation; neither operand is written)."""
    return {k: a[k] + b[k] for k in STAT_KEYS}


def expert_stats(
    expert_idx: torch.Tensor,          # (N, k) int routed expert ids
    probs: torch.Tensor,               # (N, E) full router distribution
    num_experts: int,
    valid_mask: Optional[torch.Tensor] = None,   # (N,) bool tail mask
    dropped: Optional[torch.Tensor] = None,      # () int capacity drops
) -> Dict[str, torch.Tensor]:
    """Device-side router telemetry of one MoE layer's routing decisions.

    ``expert_tokens[e]`` counts the valid token-slot assignments to
    expert ``e`` (a token routed to k experts adds k). The entropy sum is
    over each valid token's full router distribution (natural log, out of
    the autograd graph); ``tokens`` is the valid-token count the host
    divides by for the mean."""
    n, k = expert_idx.shape
    dev = expert_idx.device
    idx = expert_idx.detach().reshape(-1).long()
    p = probs.detach().float()
    # p log p is 0 where p is 0 (the clamp keeps the log finite), the value
    # JAX's where() gives; negating the sum is exact, as negating each term
    plogp = torch.sum(p * torch.log(torch.clamp(p, min=1e-30)), dim=-1)
    counts = torch.zeros((num_experts,), dtype=torch.int32, device=dev)
    if valid_mask is None:
        # the common case in few launches: the decode step pays them a layer
        counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
        entropy = -torch.sum(plogp)
        tokens = torch.full((), n, dtype=torch.int32, device=dev)
    else:
        vtok = valid_mask.detach().to(torch.int32)
        counts.scatter_add_(0, idx, vtok[:, None].expand(n, k).reshape(-1))
        entropy = -torch.sum(plogp * vtok)
        tokens = torch.sum(vtok, dtype=torch.int32)
    return {
        "expert_tokens": counts,
        "dropped_tokens": (torch.zeros((), dtype=torch.int32, device=dev)
                           if dropped is None
                           else dropped.detach().to(torch.int32)),
        "entropy_sum": entropy,
        "tokens": tokens,
    }


def load_imbalance(expert_tokens: np.ndarray) -> float:
    """Host-side load-imbalance factor: max over experts / mean over
    experts of the token counts (1.0 = balanced; 0 when nothing was
    routed)."""
    counts = np.asarray(expert_tokens, np.float64)
    mean = counts.mean()
    return float(counts.max() / mean) if mean > 0 else 0.0


class RouterStatsDrain:
    """Asynchronous device-to-host drain of ``expert_stats`` outputs.

    ``push`` is O(1) and never synchronises: it appends the step's device
    tensors to a bounded pending list. ``flush`` copies everything
    pending to the host and aggregates it into the registry in push
    order: within one drain, step ``i``'s contribution lands before step
    ``i+1``'s. Both run on the thread that runs the steps."""

    def __init__(self, registry, num_experts: int, phase: str,
                 max_pending: int = 4096):
        self.registry = registry
        self.num_experts = num_experts
        self.phase = phase
        self.max_pending = max_pending
        self._pending: List[dict] = []
        self.total = np.zeros((num_experts,), np.int64)
        self.total_dropped = 0
        self.total_tokens = 0
        self.entropy_sum = 0.0

    def push(self, stats: Optional[dict]) -> None:
        """Queue one step's device stats (no device-to-host copy here).
        Flushes only when the pending list reaches its bound."""
        if stats is None:
            return
        self._pending.append(stats)
        if len(self._pending) >= self.max_pending:
            self.flush()

    def _host(self, pending: List[dict]) -> dict:
        """The pending stats on the host: one stacked copy a key."""
        return {k: torch.stack([st[k].detach() for st in pending])
                .cpu().numpy() for k in STAT_KEYS}

    def flush(self) -> None:
        """Copy all pending stats to the host and publish them: per-expert
        token counters, drop counters, the routed-token counter, and the
        derived gate-entropy and load-imbalance gauges."""
        if not self._pending:
            self._publish_gauges()
            return
        pending, self._pending = self._pending, []
        host = self._host(pending)
        for i in range(len(pending)):
            self.total += host["expert_tokens"][i].astype(np.int64)
            self.total_dropped += int(host["dropped_tokens"][i])
            self.total_tokens += int(host["tokens"][i])
            self.entropy_sum += float(host["entropy_sum"][i])
        reg = self.registry
        c = reg.counter("repro_router_expert_tokens_total",
                        "per-expert routed token-slot assignments",
                        labels=("phase", "expert"))
        # counters are monotonic: re-publish by adding the delta between
        # the running total and what the series already holds
        for e in range(self.num_experts):
            cur = _series_value(c, (self.phase, str(e)))
            c.labels(self.phase, str(e)).inc(float(self.total[e]) - cur)
        d = reg.counter("repro_router_dropped_tokens_total",
                        "capacity-overflow dropped token slots",
                        labels=("phase",))
        d.labels(self.phase).inc(
            float(self.total_dropped) - _series_value(d, (self.phase,)))
        t = reg.counter("repro_router_routed_tokens_total",
                        "valid tokens routed through MoE layers",
                        labels=("phase",))
        t.labels(self.phase).inc(
            float(self.total_tokens) - _series_value(t, (self.phase,)))
        self._publish_gauges()

    def _publish_gauges(self) -> None:
        reg = self.registry
        if self.total_tokens > 0:
            reg.gauge("repro_router_gate_entropy",
                      "mean router-distribution entropy (nats)",
                      labels=("phase",)).labels(self.phase).set(
                self.entropy_sum / self.total_tokens)
        if self.total.sum() > 0:
            reg.gauge("repro_router_load_imbalance",
                      "max/mean per-expert token load",
                      labels=("phase",)).labels(self.phase).set(
                load_imbalance(self.total))


def _series_value(family, key: tuple) -> float:
    child = getattr(family, "children", {}).get(key)
    return float(child.value) if child is not None else 0.0
