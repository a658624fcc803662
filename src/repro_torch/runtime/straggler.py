"""Straggler detection feeding the heterogeneous-aware planner
(counterpart of ``repro.runtime.straggler``).

The paper (§4.4) measures device capacity once, offline, with a proxy task.
At 1000-node scale capacity is *dynamic*: thermal throttling, ECC retries
and preemption-neighbour noise degrade individual workers. This module
closes the loop the paper leaves manual (DESIGN.md §6): observed per-worker
step times -> implied capacities -> ``core.hetero.replan_from_step_times``
-> new batch shares -> a new ``HeteroPlan`` whose Eq. 1 split the execution
layer runs (``parallel.moe_parallel``), one step function per distinct
plan kept in ``parallel.cache.PlanCache``.

The per-worker timings arrive through the ``report()`` interface (host
telemetry, or the train CLI's ``--simulate-skew``); the logic is pure
numpy and holds to the JAX package's on synthetic timelines.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core.hetero import (
    HeteroPlan,
    clamp_shares,
    proportional_split,
    replan_from_step_times,
)


@dataclasses.dataclass
class StragglerConfig:
    """Replan-trigger policy (DESIGN.md §6 feedback loop).

    ``capacity`` caps any single worker's share: the SPMD layout allocates a
    fixed padded shard per device (``HeteroPlan.batch_capacity``), so a
    replan must never assign more rows than the shard holds — overflow is
    redistributed to workers with slack (``core.hetero.clamp_shares``)."""
    window: int = 16              # steps of history per worker
    trigger_ratio: float = 1.3    # worker slower than ratio*median -> replan
    min_steps_between_replans: int = 32
    quantum: int = 1              # batch-share granularity
    capacity: Optional[int] = None  # max share per worker (padded shard rows)


class StragglerMonitor:
    """Sliding-window step-time monitor that emits new Eq. 1 shares.

    Seed it with a ``HeteroPlan`` to start from the offline proxy-task split
    (paper Table 3) instead of uniform; ``current_plan()`` then returns the
    plan the execution layer should run now (DESIGN.md §6)."""

    def __init__(self, num_workers: int, global_batch: int,
                 cfg: StragglerConfig = StragglerConfig(),
                 plan: Optional[HeteroPlan] = None):
        self.cfg = cfg
        self.num_workers = num_workers
        self.global_batch = global_batch
        self._base_plan = plan
        if plan is not None and plan.token_counts is not None:
            if len(plan.token_counts) != num_workers:
                raise ValueError(
                    f"plan has {len(plan.token_counts)} shares for "
                    f"{num_workers} workers"
                )
            self.shares = list(plan.token_counts)
            if cfg.capacity is None and plan.token_capacity is not None:
                self.cfg = dataclasses.replace(
                    cfg, capacity=plan.token_capacity,
                    quantum=plan.token_quantum,
                )
        else:
            self.shares = proportional_split(
                [1.0] * num_workers, global_batch, quantum=cfg.quantum
            )
        self._hist = [deque(maxlen=cfg.window) for _ in range(num_workers)]
        self._last_replan = -10**9
        self._step = 0
        self.replans = 0

    def report(self, step_times_s: Sequence[float]) -> Optional[list[int]]:
        """Record one step's per-worker times; return new shares if a
        replan triggered, else None. New shares respect the capacity cap
        (``core.hetero.clamp_shares``) so the SPMD shard shapes never
        change — only the step function does (plan-keyed, ``PlanCache``)."""
        self._step += 1
        for h, t in zip(self._hist, step_times_s):
            h.append(t)
        if obs.registry.enabled:
            g = obs.registry.gauge(
                "repro_straggler_worker_step_seconds",
                "windowed mean step time per worker", labels=("worker",))
            for i, h in enumerate(self._hist):
                if h:
                    g.labels(str(i)).set(float(np.mean(h)))
        if self._step - self._last_replan < self.cfg.min_steps_between_replans:
            return None
        if min(len(h) for h in self._hist) < self.cfg.window // 2:
            return None
        means = np.array([np.mean(h) for h in self._hist])
        med = np.median(means)
        if np.max(means) < self.cfg.trigger_ratio * med:
            return None
        new = replan_from_step_times(
            means, self.shares, self.global_batch,
            quantum=self.cfg.quantum, smoothing=0.7,
        )
        if self.cfg.capacity is not None:
            new = clamp_shares(
                new, self.cfg.capacity, quantum=self.cfg.quantum
            )
        self._last_replan = self._step
        self.replans += 1
        obs.registry.counter(
            "repro_straggler_replans_total",
            "replans triggered by the straggler monitor").inc()
        self.shares = new
        return new

    def current_plan(self) -> Optional[HeteroPlan]:
        """The HeteroPlan to execute now: the seed plan with the latest
        shares (None when the monitor was not seeded with a plan)."""
        if self._base_plan is None:
            return None
        return self._base_plan.with_token_counts(self.shares)
