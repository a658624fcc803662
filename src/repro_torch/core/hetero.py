"""Heterogeneous-aware workload allocation (paper §4.4, Eq. 1/2;
counterpart of ``repro.core.hetero``).

The paper measures per-device capacity t_i on a proxy task and assigns

  data-centric :  B_i = (1/t_i) / sum_j(1/t_j) * B_global        (Eq. 1)
  model-centric:  h_i = (1/t_i) / sum_j(1/t_j) * H               (Eq. 2)

with integer rounding that preserves the exact global total (the
largest-remainder method, so every split equals the JAX package's).
Heterogeneity arises from mixed GPU generations in one job and, at run
time, from degraded devices (stragglers): observed per-device step times
feed back into ``replan_from_step_times``.

Also includes the synchronous-step latency model of the paper's Table 3 /
Figure 11 ("the proportional split minimises latency"). Plain numpy: the
plans are host-side and decide shapes before anything runs on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.common import round_up


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Per-device capacity measurement (paper Table 3)."""
    name: str
    proxy_latency_s: float  # t_i from the proxy task

    @property
    def capacity(self) -> float:
        return 1.0 / self.proxy_latency_s


def proportional_split(
    latencies: Sequence[float], total: int, *, quantum: int = 1
) -> list[int]:
    """Split ``total`` units proportional to 1/t_i (Eq. 1/2), rounded to
    multiples of ``quantum`` while preserving the exact total.

    ``quantum`` keeps model-centric splits tile-aligned (e.g. 128-multiple
    hidden sub-dimensions): the port's expert kernels step the hidden
    dimension in 64- and 128-wide tiles, and a slice that ends mid-tile
    computes the rest of that tile on zeros.
    """
    t = np.asarray(latencies, dtype=np.float64)
    if np.any(t <= 0):
        raise ValueError("latencies must be positive")
    if total % quantum != 0:
        raise ValueError(f"total {total} not a multiple of quantum {quantum}")
    weights = (1.0 / t) / np.sum(1.0 / t)
    units = total // quantum
    raw = weights * units
    base = np.floor(raw).astype(np.int64)
    # Largest-remainder method to distribute the leftover units.
    leftover = units - int(base.sum())
    order = np.argsort(-(raw - base))
    base[order[:leftover]] += 1
    out = (base * quantum).astype(np.int64)
    assert out.sum() == total
    return [int(v) for v in out]


def plan_data_centric(
    profiles: Sequence[DeviceProfile], global_batch: int
) -> list[int]:
    """Eq. 1: per-device local batch sizes."""
    return proportional_split(
        [p.proxy_latency_s for p in profiles], global_batch
    )


def fit_quantum(total: int, quantum: int, num_devices: int) -> int:
    """Largest power-of-two divisor of ``quantum`` that lets ``total`` be
    split into >= ``num_devices`` quantum-multiples."""
    q = quantum
    while total % q != 0 or total // q < num_devices:
        q //= 2
        if q == 0:
            raise ValueError("total too small for the device count")
    return q


def plan_model_centric(
    profiles: Sequence[DeviceProfile], hidden_size: int, *, quantum: int = 128
) -> list[int]:
    """Eq. 2: per-device FFN hidden sub-dimensions (tile-aligned)."""
    q = fit_quantum(hidden_size, quantum, len(profiles))
    return proportional_split(
        [p.proxy_latency_s for p in profiles], hidden_size, quantum=q
    )


def step_latency_model(
    profiles: Sequence[DeviceProfile],
    shares: Sequence[int],
    total_work: int,
    *,
    fixed_overhead_s: float = 0.0,
) -> float:
    """Synchronous-step latency: max over devices of (work share) * t_i /
    (work unit). A device's time is proportional to its share and its
    measured per-unit latency; the step completes when the slowest finishes
    (the all-reduce barrier)."""
    per_unit = np.array([p.proxy_latency_s for p in profiles]) / total_work
    times = np.asarray(shares) * per_unit * len(profiles)
    return float(np.max(times) + fixed_overhead_s)


def replan_from_step_times(
    step_times_s: Sequence[float],
    current_shares: Sequence[int],
    total: int,
    *,
    quantum: int = 1,
    smoothing: float = 0.5,
) -> list[int]:
    """Runtime straggler mitigation: observed per-device step times imply new
    capacities (time / share = per-unit latency); re-split proportionally.
    ``smoothing`` blends old and new implied latencies (EMA) so transient
    noise does not thrash the allocation."""
    shares = np.asarray(current_shares, dtype=np.float64)
    times = np.asarray(step_times_s, dtype=np.float64)
    per_unit = times / np.maximum(shares, 1)
    uniform = np.full_like(per_unit, per_unit.mean())
    blended = smoothing * per_unit + (1 - smoothing) * uniform
    return proportional_split(blended, total, quantum=quantum)


def clamp_shares(
    shares: Sequence[int], capacity: int, *, quantum: int = 1
) -> list[int]:
    """Cap each share at ``capacity`` and redistribute the overflow to
    devices with slack (largest-slack first), preserving the exact total.

    The runtime replan loop needs this: the SPMD layout's
    per-device shard is a *fixed* padded shape, so no replan may assign a
    device more rows than its allocated capacity. Raises if the total
    exceeds ``capacity * num_devices`` (nowhere to put the overflow).
    """
    if capacity % quantum != 0:
        raise ValueError(f"capacity {capacity} not a multiple of {quantum}")
    s = np.asarray(shares, dtype=np.int64)
    total = int(s.sum())
    if total > capacity * len(s):
        raise ValueError(
            f"total {total} exceeds aggregate capacity {capacity * len(s)}"
        )
    out = np.minimum(s, capacity)
    overflow = total - int(out.sum())
    # Hand overflow out in quantum units, biggest slack first.
    while overflow > 0:
        order = np.argsort(-(capacity - out))
        for i in order:
            if overflow <= 0:
                break
            take = min(overflow, capacity - int(out[i]), quantum)
            if take > 0:
                out[i] += take
                overflow -= take
    assert out.sum() == total
    return [int(v) for v in out]


# ---------------------------------------------------------------------------
# execution plan — the object the runtime actually executes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeteroPlan:
    """A concrete per-device allocation the execution layer runs (§4.4 made
    executable).

    ``token_counts``  — Eq. 1: valid batch rows per data-split group member.
                        The SPMD shard keeps a *uniform* padded shape
                        (``batch_capacity`` rows per device); rows past a
                        device's count are masked in routing and contribute
                        zero output and zero gradient.
    ``hidden_splits`` — Eq. 2: real FFN hidden columns per TP group member.
                        Realised as a zero-padded tile-aligned slice per
                        device (``hidden_capacity`` columns each); padded
                        columns hold exact zeros, so the computation equals
                        the unpadded uneven split bitwise per device.
    ``proxy_latencies`` — the t_i that produced the splits; kept on the plan
                        so the autotune roofline can evaluate the uneven-
                        split latency term and so replans can EMA against
                        the original measurement.
    ``expert_bits``   — per-device-class expert-weight storage bits:
                        8 ⇒ that class holds block-wise int8 expert
                        payloads (smaller HBM footprint AND a smaller
                        weight-byte roofline term), 16 ⇒ full precision.
                        Low-HBM classes go 8 while big devices stay 16;
                        ``parallel.hetero_exec`` quantizes each class's
                        weight slice accordingly and the autotune chooser
                        prices the uneven split with per-device bits.

    The plan is hashable and static: every distinct plan cuts its own
    per-device shapes (the replan loop bounds how many it keeps with a
    plan-keyed cache, ``parallel.cache.PlanCache``).
    """
    proxy_latencies: tuple    # per-device t_i (seconds on the proxy task)
    token_counts: Optional[tuple] = None   # Eq. 1 B_i (batch rows/device)
    hidden_splits: Optional[tuple] = None  # Eq. 2 h_i (FFN cols/device)
    token_quantum: int = 1
    hidden_quantum: int = 128
    token_capacity: Optional[int] = None   # fixed SPMD rows/device (headroom)
    #: When the data group and the TP group are different device sets (a 2-D
    #: mesh), these are the TP group's t_i; ``hidden_splits`` derive from
    #: them. None ⇒ ``proxy_latencies`` covers both groups.
    tp_latencies: Optional[tuple] = None
    expert_bits: Optional[tuple] = None    # per-class weight bits (8 | 16)

    def __post_init__(self):
        if self.token_counts is not None and self.token_capacity is not None:
            if max(self.token_counts) > self.token_capacity:
                raise ValueError(
                    f"token_counts {self.token_counts} exceed capacity "
                    f"{self.token_capacity}"
                )
        if self.expert_bits is not None:
            if any(b not in (8, 16) for b in self.expert_bits):
                raise ValueError(
                    f"expert_bits must be 8 or 16, got {self.expert_bits}"
                )
            if len(self.expert_bits) != len(self.proxy_latencies):
                raise ValueError(
                    f"expert_bits has {len(self.expert_bits)} entries for "
                    f"{len(self.proxy_latencies)} device classes"
                )

    @property
    def batch_capacity(self) -> int:
        """Padded batch rows per device in the SPMD layout."""
        if self.token_capacity is not None:
            return self.token_capacity
        return round_up(max(self.token_counts), self.token_quantum)

    @property
    def hidden_capacity(self) -> int:
        """Padded FFN columns per TP rank (tile-aligned width)."""
        return round_up(max(self.hidden_splits), self.hidden_quantum)

    def padded_hidden_size(self) -> int:
        """Global FFN hidden size after per-device tile padding (= d_ff when
        the split is even and quantum-aligned: no padding needed)."""
        return self.hidden_capacity * len(self.hidden_splits)

    def hidden_padded(self) -> bool:
        return (self.hidden_splits is not None
                and self.padded_hidden_size() != sum(self.hidden_splits))

    def key(self) -> tuple:
        """Hashable key: what the per-device programs' shapes depend on."""
        return (self.token_counts, self.hidden_splits,
                self.token_capacity, self.token_quantum,
                self.hidden_quantum, self.expert_bits)

    def with_token_counts(self, counts: Sequence[int]) -> "HeteroPlan":
        """Replan step: same plan, new Eq. 1 shares (capacity-clamped)."""
        counts = tuple(int(c) for c in counts)
        if self.token_capacity is not None:
            counts = tuple(clamp_shares(
                counts, self.token_capacity, quantum=self.token_quantum
            ))
        return dataclasses.replace(self, token_counts=counts)


def make_hetero_plan(
    latencies: Sequence[float],
    *,
    global_batch: Optional[int] = None,
    hidden_size: Optional[int] = None,
    tp_latencies: Optional[Sequence[float]] = None,
    token_quantum: int = 1,
    hidden_quantum: int = 128,
    capacity_headroom: float = 1.0,
    expert_bits: Optional[Sequence[int]] = None,
) -> HeteroPlan:
    """Build the executable plan from measured proxy latencies (Eq. 1/2).

    ``global_batch`` enables the data split (token_counts over the data
    group, one entry per latency), ``hidden_size`` the model split
    (hidden_splits over the TP group — ``tp_latencies`` when that group is
    a different device set, else ``latencies``). ``capacity_headroom > 1``
    reserves extra padded rows per device so later replans can shift MORE
    load onto a device than the initial plan gave it without changing the
    SPMD shapes. ``expert_bits``: per-class expert-weight storage bits —
    low-memory classes hold int8 payloads (8), big devices stay at full
    precision (16).
    """
    lat = tuple(float(t) for t in latencies)
    tp_lat = (tuple(float(t) for t in tp_latencies)
              if tp_latencies is not None else None)
    if any(t <= 0 for t in lat + (tp_lat or ())):
        raise ValueError("latencies must be positive")
    token_counts = hidden_splits = None
    capacity = None
    if global_batch is not None:
        # The FITTED quantum is the one the plan lives by from here on:
        # replans re-split the same total on plan.token_quantum, so storing
        # the requested (unfitted) value would crash the replan path.
        token_quantum = fit_quantum(global_batch, token_quantum, len(lat))
        token_counts = tuple(
            proportional_split(lat, global_batch, quantum=token_quantum)
        )
        capacity = round_up(
            min(int(max(token_counts) * capacity_headroom), global_batch),
            token_quantum,
        )
    if hidden_size is not None:
        hl = tp_lat if tp_lat is not None else lat
        # Same fitting for the hidden side: hidden_capacity (tile width)
        # must round to the quantum the split actually used, or small d_ff
        # would silently pad far past the real hidden size.
        hidden_quantum = fit_quantum(hidden_size, hidden_quantum, len(hl))
        hidden_splits = tuple(
            proportional_split(hl, hidden_size, quantum=hidden_quantum)
        )
    return HeteroPlan(
        proxy_latencies=lat,
        token_counts=token_counts,
        hidden_splits=hidden_splits,
        token_quantum=token_quantum,
        hidden_quantum=hidden_quantum,
        token_capacity=capacity,
        tp_latencies=tp_lat,
        expert_bits=(tuple(int(b) for b in expert_bits)
                     if expert_bits is not None else None),
    )


def uniform_plan(num_devices: int, **kwargs) -> HeteroPlan:
    """Equal-latency plan: splits degenerate to the uniform path (and the
    execution layer short-circuits all masking — the uniform path's
    operations, bit for bit)."""
    return make_hetero_plan([1.0] * num_devices, **kwargs)


def uniform_counterpart(plan: HeteroPlan) -> HeteroPlan:
    """The uniform-split baseline arm of an A/B comparison: same totals,
    same latencies (so the same simulated skew), equal shares per split
    group (each split keeps ITS group size — token and hidden groups can
    differ on a 2-D mesh).

    ``token_capacity`` is reset — uniform counts can exceed the skewed
    plan's kept capacity and ``HeteroPlan.__post_init__`` would reject
    them. Rejects totals whose equal shares would be uneven or (hidden
    side) quantum-misaligned: a baseline arm must execute the same
    tile-aligned shapes the proportional arm does."""
    counts = splits = None
    if plan.token_counts is not None:
        n = len(plan.token_counts)
        total = sum(plan.token_counts)
        if total % n:
            raise ValueError(f"token total {total} not divisible by {n}")
        counts = (total // n,) * n
    if plan.hidden_splits is not None:
        n = len(plan.hidden_splits)
        total = sum(plan.hidden_splits)
        if total % n:
            raise ValueError(f"hidden total {total} not divisible by {n}")
        if (total // n) % plan.hidden_quantum:
            raise ValueError(
                f"uniform hidden share {total // n} is not a multiple of "
                f"the plan's hidden_quantum {plan.hidden_quantum}"
            )
        splits = (total // n,) * n
    return dataclasses.replace(
        plan, token_counts=counts, hidden_splits=splits, token_capacity=None
    )


def hidden_mask(plan: HeteroPlan, dtype=np.float32) -> np.ndarray:
    """(padded_hidden_size,) column-validity mask for the model split.

    Global padded column c belongs to TP rank ``c // hidden_capacity``;
    it is real iff its offset within the rank's tile is < h_i. Multiplying
    the initialised expert weights by this mask zeroes the padded columns,
    and they stay zero under training: the forward contribution of a zero
    column is exactly zero, so its gradient is exactly zero (the padding
    invariant)."""
    cap = plan.hidden_capacity
    mask = np.zeros((plan.padded_hidden_size(),), dtype=dtype)
    for i, h in enumerate(plan.hidden_splits):
        mask[i * cap: i * cap + h] = 1
    return mask


def pack_batch(batch: dict, plan: HeteroPlan) -> dict:
    """Re-pack a (B_total, ...) host batch into the plan's padded SPMD
    layout: device i's shard holds its Eq. 1 share ``token_counts[i]`` in
    rows [i*C, i*C + B_i) of a (n_dev * C, ...) array (C = batch_capacity);
    tail rows are zero ('loss_mask' zero ⇒ no loss; the MoE island masks
    them out of routing and the aux losses)."""
    counts = plan.token_counts
    cap = plan.batch_capacity
    n = len(counts)
    assert sum(counts) <= batch_size_of(batch), (
        "plan assigns more rows than the batch holds")
    offsets = np.concatenate([[0], np.cumsum(counts)])
    out = {}
    for name, arr in batch.items():
        a = np.asarray(arr)
        dst = np.zeros((n * cap,) + a.shape[1:], a.dtype)
        for i, b_i in enumerate(counts):
            dst[i * cap: i * cap + b_i] = a[offsets[i]: offsets[i] + b_i]
        out[name] = dst
    return out


def batch_size_of(batch: dict) -> int:
    """Leading-dim size of a host batch dict (all leaves agree)."""
    return int(next(iter(batch.values())).shape[0])
