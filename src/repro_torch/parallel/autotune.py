"""Adaptive data-/model-centric dispatch (paper §4.5, Fig. 10) at run time
(counterpart of ``repro.parallel.autotune``).

The paper's observation: for one MoE FFN layer the collective bill is
token-proportional under model-centric execution (all-gather tokens over TP,
reduce partial outputs; weights stationary) but constant under data-centric
execution (all-gather expert weights; tokens stationary). Model-centric wins
small workloads, data-centric wins large ones, and the crossover sits where
moved token bytes ≈ moved weight bytes.

  * ``layer_latency`` — the roofline itself: max(compute, HBM, link) for one
    MoE FFN layer under a given mode. Byte/FLOP terms only; no device state.
  * ``choose_mode`` / ``crossover_tokens`` — argmin over modes for a given
    token workload, and the workload where the winner flips.
  * ``resolve_layer_mode`` — the hook ``moe_parallel.moe_layer`` calls when
    ``ParallelConfig.mode == "auto"``: derives (d, f, e, k) from the param
    shapes, the TP group size from the mesh, and an effective device count
    from heterogeneous ``core.hetero.DeviceProfile`` measurements.
  * ``plan_layer_modes`` — a whole-model per-layer plan (one entry per
    period position) that can be pinned into ``ParallelConfig.layer_mode_plan``.

The decision is a pure function of shapes, made on the host before any
collective is issued, so ``mode="auto"`` runs exactly the operations of the
equivalent forced mode (the same values, bit for bit). The default
hardware profile, ``H100_SXM``, holds the constants of the card the port
runs on: its peak and memory rate as measured there, its link rate as
NVIDIA publishes it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs


@dataclasses.dataclass(frozen=True)
class Topology:
    """Two-level interconnect: fast links inside a node of
    ``node_size`` devices (``intra_bw`` bytes/s per link), slow links across
    nodes (``inter_bw``). ``n_nodes(n) <= 1`` degenerates to a flat fabric:
    every price is computed with the *same expression* as the topology-less
    roofline, so a flat ``Topology(intra_bw=hw.link_bw, ...)`` prices
    exactly as no topology does.

    The defaults are NVIDIA's published figures for an HGX H100 node, not
    measurements: 8 GPUs a node, NVLink 4 at 900 GB/s a GPU (450 GB/s
    each way), and one 400 Gb/s NDR InfiniBand port a GPU across nodes
    (50 GB/s)."""
    intra_bw: float = 450e9
    inter_bw: float = 50e9
    node_size: int = 8

    def __post_init__(self):
        if self.intra_bw <= 0 or self.inter_bw <= 0:
            raise ValueError("topology bandwidths must be positive")
        if self.node_size < 1:
            raise ValueError("node_size must be >= 1")

    def n_nodes(self, n_dev: float) -> int:
        """Number of nodes an ``n_dev``-wide group spans (ceil division)."""
        return int(math.ceil(float(n_dev) / self.node_size))

    def is_flat(self, n_dev: float) -> bool:
        """True when the group fits inside one node (single-level fabric)."""
        return self.n_nodes(n_dev) <= 1

    @staticmethod
    def parse(spec: str) -> "Topology":
        """Parse the form ``intra:inter:node_size`` (bytes/s, e.g.
        ``450e9:50e9:8``)."""
        parts = spec.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"--topology expects intra_bw:inter_bw:node_size, got {spec!r}")
        return Topology(intra_bw=float(parts[0]), inter_bw=float(parts[1]),
                        node_size=int(parts[2]))


#: The card's measured rates (``chip_smoke.py`` phase R; see ``H100_SXM``):
#: the median of three calls on an NVIDIA H100 80GB HBM3 at a 700.00 W
#: power limit, which read 745.5, 759.7 and 794.2 TFLOP/s from a bf16
#: 8192^3 matmul and 3.016, 3.017 and 3.038 TB/s from a 2 GiB copy. The
#: median leaves room on both sides of phase R's 10 % check.
PHASE_R_PEAK_FLOPS = 759.7e12
PHASE_R_HBM_BW = 3.017e12


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Per-device roofline constants (bytes/s, FLOP/s).

    ``topology``: optional two-level interconnect; ``None``
    keeps the flat single-bandwidth fabric priced at ``link_bw``."""
    peak_flops: float
    hbm_bw: float
    link_bw: float
    topology: Optional[Topology] = None


#: One NVIDIA H100 SXM. ``peak_flops`` and ``hbm_bw`` are measured on the
#: card by ``chip_smoke.py``'s phase R (the median of a bf16 8192^3
#: ``torch.matmul``; a device-to-device copy of 2 GiB, read + write bytes)
#: on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit. ``link_bw`` is
#: not measured (one card has no link to time): NVIDIA's published NVLink 4
#: bandwidth of the H100 SXM, 900 GB/s a GPU, counted as 450 GB/s each way.
H100_SXM = HardwareProfile(
    peak_flops=PHASE_R_PEAK_FLOPS,
    hbm_bw=PHASE_R_HBM_BW,
    link_bw=450e9,
)


def _token_coll_cost(tok_bytes: float, n_dev: float, hw: HardwareProfile) -> float:
    """Link time of model-centric's token collectives (AG in + RS out).

    Token shards and the node-combined partial sums are *distinct* bytes per
    device, so the inter-node term stays per-device: the hierarchical credit
    is exactly the node-local combine collapsing ``node_size`` partial-sum
    copies into one before the cross-node exchange — ``(nn-1)/nn`` instead of
    ``(n-1)/n`` per direction."""
    topo = hw.topology
    if topo is None:
        return (tok_bytes + tok_bytes) / hw.link_bw
    if topo.is_flat(n_dev):
        return (tok_bytes + tok_bytes) / topo.intra_bw
    ns = min(topo.node_size, max(int(n_dev), 1))
    nn = topo.n_nodes(n_dev)
    intra = 2 * tok_bytes * (ns - 1) / ns / topo.intra_bw
    inter = 2 * tok_bytes * (nn - 1) / nn / topo.inter_bw
    return intra + inter


def _weight_coll_cost(w_bytes: float, n_dev: float, hw: HardwareProfile) -> float:
    """Link time of data-centric's expert-weight all-gather.

    Weights are *identical* bytes for every consumer, so the hierarchical
    gather lands each byte on a node exactly once over the slow fabric
    (per-NIC share ``1/node_size``) and fans out over the fast intra links —
    the staging that makes data-centric relatively cheaper as
    ``inter_bw/intra_bw`` shrinks."""
    topo = hw.topology
    if topo is None:
        return w_bytes * (n_dev - 1) / n_dev / hw.link_bw
    if topo.is_flat(n_dev):
        return w_bytes * (n_dev - 1) / n_dev / topo.intra_bw
    ns = min(topo.node_size, max(int(n_dev), 1))
    nn = topo.n_nodes(n_dev)
    intra = w_bytes * (ns - 1) / ns / topo.intra_bw
    inter = w_bytes * (nn - 1) / nn / (ns * topo.inter_bw)
    return intra + inter


def dispatch_inter_bytes(
    tokens: int,
    d: int,
    k: int,
    *,
    n_dev: int,
    node_size: int,
    itemsize: int = 2,
    hierarchical: bool = True,
) -> float:
    """Expected inter-node bytes of a top-k expert all-to-all dispatch.

    Flat dispatch sends each of a token's ``k`` expert copies to its owner
    device: ``k * (nn-1)/nn`` copies cross nodes in expectation (uniform
    routing). Hierarchical dispatch sends a token to a remote
    node ONCE if >= 1 of its k experts lives there and replicates over the
    fast intra links: ``(nn-1) * (1 - (1 - 1/nn)**k)`` expected crossings —
    the local top-k overlap factor. Bernoulli gives hierarchical <= flat for
    every (k, node_size), which tests/test_topology.py samples."""
    nn = int(math.ceil(n_dev / max(node_size, 1)))
    if nn <= 1:
        return 0.0
    per_tok = float(tokens) * d * itemsize
    if not hierarchical:
        return per_tok * k * (nn - 1) / nn
    return per_tok * (nn - 1) * (1.0 - (1.0 - 1.0 / nn) ** k)


def moe_coll_bytes(
    mode: str,
    tokens: int,
    d: int,
    f: int,
    e: int,
    k: int,
    *,
    n_dev: int,
    topology: Topology,
    hierarchical: bool = True,
    weight_bits: int = 16,
) -> Tuple[float, float]:
    """(intra_bytes, inter_bytes) one MoE layer's collectives move per device
    on a two-level fabric, under the flat vs hierarchical schedule.

    The flat schedule's ring spans nodes, so its whole per-device volume is
    paced by (and billed to) the inter level; the hierarchical schedule
    splits the volume per level."""
    tok_bytes = float(tokens) * d * 2
    w_bytes = float(e) * 2 * d * f * (weight_bits / 8)
    n = max(int(n_dev), 1)
    ns = min(topology.node_size, n)
    nn = topology.n_nodes(n)
    if mode == "model_centric":
        vol = 2 * tok_bytes * (n - 1) / n
        if nn <= 1:
            return (vol, 0.0)
        if not hierarchical:
            return (0.0, vol)
        return (2 * tok_bytes * (ns - 1) / ns,
                2 * tok_bytes * (nn - 1) / nn)
    if mode == "data_centric":
        vol = w_bytes * (n - 1) / n
        if nn <= 1:
            return (vol, 0.0)
        if not hierarchical:
            return (0.0, vol)
        return (w_bytes * (ns - 1) / ns,
                w_bytes * (nn - 1) / nn / ns)
    raise ValueError(mode)

#: Modes the runtime chooser may return, in tie-break preference order:
#: when the roofline says equal (usually both compute-bound), prefer
#: model-centric — it moves no weights, so it never inflates HBM residency.
CHOOSABLE_MODES = ("model_centric", "data_centric")


def layer_latency(
    mode: str,
    tokens: int,
    d: int,
    f: int,
    e: int,
    k: int,
    n_dev: float = 16,
    hw: HardwareProfile = H100_SXM,
    *,
    fused_ffn: bool = True,
    weight_bits: int = 16,
) -> float:
    """One MoE FFN layer (fwd), bf16, on an ``n_dev`` TP/DP group.

    model_centric: tokens all-gathered over TP + partial-output reduction;
                   weights stationary.
    data_centric : weights all-gathered over the group (pipeline-shared
                   cache re-fill per layer); tokens stationary.
    ``n_dev`` may be fractional: heterogeneous groups report an *effective*
    device count (see ``effective_devices``).
    ``fused_ffn``: with the fused expert FFN (``kernels.esffn``, the
    default) inter-stage activations stay on chip. Unfused, the
    HBM term additionally pays the (Np, D) sorted-copy and (Np, F) hidden
    round-trips between the 3-4 separate kernels — which inflates the
    token-proportional side of the roofline and moves the data-/model-
    centric crossover.
    ``weight_bits``: expert-weight storage bits. Quantized
    experts (8) shrink the weight term of BOTH the HBM and the all-gather
    bills while the token bytes stay bf16 — data-centric's constant
    weight-movement cost halves, so the crossover shifts toward FEWER
    tokens (data-centric wins earlier).
    """
    active_rows = tokens * k
    flops = 2 * active_rows * d * f * 2  # two MLPs
    w_bytes = e * 2 * d * f * (weight_bits / 8)  # full expert params
    tok_bytes = tokens * d * 2
    # Unfused inter-stage HBM round-trips (1 write + 1 read each), bf16:
    # the expert-sorted (Np, D) copy and the (Np, F) hidden activations.
    srt_bytes = 2 * active_rows * d * 2
    hid_bytes = 2 * active_rows * f * 2
    if mode == "model_centric":
        compute = flops / n_dev / hw.peak_flops   # rows x F/n per device
        mem = (w_bytes / n_dev + tok_bytes) / hw.hbm_bw
        if not fused_ffn:
            # every device holds the whole group's gathered tokens; the
            # hidden is TP-sharded over F.
            mem += (srt_bytes + hid_bytes / n_dev) / hw.hbm_bw
        coll = _token_coll_cost(tok_bytes, n_dev, hw)  # AG tokens + RS outputs
    elif mode == "data_centric":
        compute = flops / n_dev / hw.peak_flops   # tokens/n per device
        mem = (w_bytes + tok_bytes / n_dev) / hw.hbm_bw
        if not fused_ffn:
            # tokens (and therefore both round-trips) are split over devices.
            mem += (srt_bytes + hid_bytes) / n_dev / hw.hbm_bw
        coll = _weight_coll_cost(w_bytes, n_dev, hw)  # AG weights
    else:
        raise ValueError(mode)
    return max(compute, mem, coll)


def layer_latency_uneven(
    mode: str,
    tokens: int,
    d: int,
    f: int,
    e: int,
    k: int,
    latencies: Sequence[float],
    *,
    token_shares: Optional[Sequence[int]] = None,
    hidden_shares: Optional[Sequence[int]] = None,
    hw: HardwareProfile = H100_SXM,
    fused_ffn: bool = True,
    weight_bits=16,
) -> float:
    """Uneven-split roofline: max over devices of each device's latency
    under its Eq. 1/2 share (paper §4.4 executed;).

    ``weight_bits`` may be a scalar or a per-device sequence (a plan's
    ``expert_bits``): device i's weight-byte terms use its
    own class's storage width, so an int8 low-HBM class sees a smaller
    HBM bill than its bf16 peers.

    Replaces the ``effective_devices`` scalar approximation when an actual
    per-device allocation is known: device ``i`` runs at ``t_min/t_i`` of
    the fastest chip's roofline (compute AND HBM scaled; link bandwidth is
    topology, not silicon, and stays flat) and carries
    ``token_shares[i]/Σ`` of the tokens (data-centric) or
    ``hidden_shares[i]/Σ`` of the hidden columns (model-centric). With the
    proportional split the per-device latencies equalise and the max
    coincides with the effective-devices approximation; any other split is
    strictly worse — which is the Fig. 11 claim this term lets the chooser
    see.
    """
    t = np.asarray(latencies, dtype=np.float64)
    if np.any(t <= 0):
        raise ValueError("latencies must be positive")
    n = len(t)
    speed = np.min(t) / t  # relative per-device speed, fastest = 1
    if token_shares is None:
        token_shares = [tokens // n] * n
    if hidden_shares is None:
        hidden_shares = [f // n] * n
    tok_frac = np.asarray(token_shares, np.float64) / max(sum(token_shares), 1)
    hid_frac = np.asarray(hidden_shares, np.float64) / max(sum(hidden_shares), 1)

    bits = (list(weight_bits) if not isinstance(weight_bits, (int, float))
            else [weight_bits] * n)
    if len(bits) != n:
        raise ValueError(
            f"weight_bits has {len(bits)} entries for {n} devices")

    active_rows = tokens * k
    flops = 2 * active_rows * d * f * 2
    tok_bytes = tokens * d * 2
    srt_bytes = 2 * active_rows * d * 2
    hid_bytes = 2 * active_rows * f * 2

    worst = 0.0
    for i in range(n):
        peak = hw.peak_flops * speed[i]
        hbm = hw.hbm_bw * speed[i]
        w_bytes = e * 2 * d * f * (bits[i] / 8)
        if mode == "model_centric":
            compute = flops * hid_frac[i] / peak
            mem = (w_bytes * hid_frac[i] + tok_bytes) / hbm
            if not fused_ffn:
                mem += (srt_bytes + hid_bytes * hid_frac[i]) / hbm
            coll = _token_coll_cost(tok_bytes, n, hw)
        elif mode == "data_centric":
            compute = flops * tok_frac[i] / peak
            mem = (w_bytes + tok_bytes * tok_frac[i]) / hbm
            if not fused_ffn:
                mem += (srt_bytes + hid_bytes) * tok_frac[i] / hbm
            coll = _weight_coll_cost(w_bytes, n, hw)
        else:
            raise ValueError(mode)
        worst = max(worst, max(compute, mem, coll))
    return worst


def effective_devices(proxy_latencies: Sequence[float]) -> float:
    """Heterogeneity-aware effective group size (paper §4.4 planner view).

    With the proportional split of Eq. 1/2 every device finishes together,
    so the group behaves like ``sum(t_min / t_i)`` devices rated at the
    fastest chip's roofline: a (1x fast + 1x half-speed) pair is worth 1.5
    fast devices, not 2.
    """
    t = np.asarray(proxy_latencies, dtype=np.float64)
    if t.size == 0:
        return 1.0
    if np.any(t <= 0):
        raise ValueError("proxy latencies must be positive")
    return float(np.sum(np.min(t) / t))


def choose_mode(
    tokens: int,
    d: int,
    f: int,
    e: int,
    k: int,
    *,
    n_dev: float = 16,
    hw: HardwareProfile = H100_SXM,
    fused_ffn: bool = True,
    weight_bits: int = 16,
) -> str:
    """argmin-latency mode for one MoE layer's token workload (ties resolve
    in CHOOSABLE_MODES order: model-centric first)."""
    if n_dev <= 1:
        # No group to move tokens or weights across: the modes coincide;
        # report data_centric (weights-stationary == weights-local).
        return "data_centric"
    costs = {
        m: layer_latency(m, tokens, d, f, e, k, n_dev, hw,
                         fused_ffn=fused_ffn, weight_bits=weight_bits)
        for m in CHOOSABLE_MODES
    }
    return min(costs, key=costs.get)


def crossover_tokens(
    d: int,
    f: int,
    e: int,
    k: int,
    *,
    n_dev: float = 16,
    hw: HardwareProfile = H100_SXM,
    fused_ffn: bool = True,
    weight_bits: int = 16,
    lo_exp: int = 4,
    hi_exp: int = 18,
) -> Optional[int]:
    """First power-of-two token count where the winner flips model->data.

    Scans the same 2**lo_exp .. 2**(hi_exp-1) grid as the Fig. 10 benchmark
    so the runtime chooser and the offline roofline agree exactly.
    Quantized experts (``weight_bits=8``) cheapen the
    data-centric weight movement and pull the crossover to fewer tokens.
    """
    prev = None
    for tokens in (2 ** i for i in range(lo_exp, hi_exp)):
        winner = choose_mode(
            tokens, d, f, e, k, n_dev=n_dev, hw=hw, fused_ffn=fused_ffn,
            weight_bits=weight_bits,
        )
        if prev is not None and prev != winner:
            return tokens
        prev = winner
    return None


# ---------------------------------------------------------------------------
# serving decode-attention pricing (paged vs dense KV)
# ---------------------------------------------------------------------------

def decode_attn_bytes(
    kind: str,
    *,
    num_slots: int,
    max_seq: int,
    hq: int,
    hkv: int,
    hd: int,
    lengths: Optional[Sequence[int]] = None,
    page: int = 16,
    itemsize: int = 2,
) -> int:
    """HBM bytes of ONE decode-attention macro-step under each cache layout.

    "dense": the kernel reads the whole up-front ``(num_slots, max_seq)``
    K/V rectangle every step — the workload-independent term the paged
    engine exists to kill.
    "paged": only the pages holding live tokens move
    (``kernels.paged_attention.paged_attn_cost``); an idle slot costs its
    query row, a short sequence its own pages. There is NO
    ``num_slots * max_seq`` term, which ``tests/test_paged_attention.py``
    pins.
    """
    from repro_torch.kernels.paged_attention import paged_attn_cost

    if kind == "dense":
        q_bytes = 2 * num_slots * hq * hd * itemsize        # q in + out
        kv_bytes = 2 * num_slots * max_seq * hkv * hd * itemsize
        return int(q_bytes + kv_bytes)
    if kind == "paged":
        lens = ([max_seq] * num_slots if lengths is None
                else [min(int(l), max_seq) for l in lengths])
        return int(paged_attn_cost(lens, page, hq, hkv, hd, itemsize)
                   ["bytes_accessed"])
    raise ValueError(kind)


def serve_decode_attn_latency(
    kind: str,
    *,
    num_slots: int,
    max_seq: int,
    hq: int,
    hkv: int,
    hd: int,
    lengths: Optional[Sequence[int]] = None,
    page: int = 16,
    itemsize: int = 2,
    hw: HardwareProfile = H100_SXM,
) -> float:
    """Roofline latency of one decode-attention macro-step: decode
    attention does O(1) FLOPs per byte, so the HBM term is the whole bill.
    This is the cost-model entry that prices the paged kernel against the
    dense layout for an actual mix of sequence lengths."""
    return decode_attn_bytes(
        kind, num_slots=num_slots, max_seq=max_seq, hq=hq, hkv=hkv, hd=hd,
        lengths=lengths, page=page, itemsize=itemsize,
    ) / hw.hbm_bw


def expected_verify_tokens(accept_rate: float, spec_k: int) -> float:
    """Expected tokens committed per speculative verify round when each drafted token independently matches the sampler with
    probability ``accept_rate``: the round commits ``i + 1`` tokens when
    the first mismatch lands on draft ``i``, so the expectation telescopes
    to ``1 + a + a^2 + ... + a^spec_k = (1 - a^(k+1)) / (1 - a)``. Bounds:
    1 at ``a = 0`` (the correction token alone) and ``spec_k + 1`` at
    ``a = 1`` (every draft and the bonus sample commit)."""
    if not 0.0 <= accept_rate <= 1.0:
        raise ValueError(f"accept_rate must be in [0, 1]: {accept_rate}")
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0: {spec_k}")
    if accept_rate >= 1.0:
        return float(spec_k + 1)
    return float((1.0 - accept_rate ** (spec_k + 1)) / (1.0 - accept_rate))


def spec_verify_latency(
    n_tokens: int,
    d: int,
    f: int,
    e: int,
    k: int,
    *,
    n_dev: float = 16,
    hw: HardwareProfile = H100_SXM,
    fused_ffn: bool = True,
    weight_bits: int = 16,
) -> float:
    """Roofline latency of ONE MoE layer scoring ``n_tokens`` drafted
    positions in a single paged forward — verification priced as a
    ``k``-row data-centric micro-batch. Decode
    (``n_tokens = 1``) is weight-bound: the whole expert weight movement
    is billed to one token, so a verify step's cost grows far slower than
    linearly in ``n_tokens`` until the token-proportional terms catch up.
    ``choose_mode`` picks the same argmin mode the serving forward's auto
    chooser will resolve for that token count, so the model prices what
    actually runs."""
    mode = choose_mode(n_tokens, d, f, e, k, n_dev=n_dev, hw=hw,
                       fused_ffn=fused_ffn, weight_bits=weight_bits)
    return layer_latency(mode, n_tokens, d, f, e, k, n_dev, hw,
                         fused_ffn=fused_ffn, weight_bits=weight_bits)


def spec_decode_speedup(
    accept_rate: float,
    spec_k: int,
    d: int,
    f: int,
    e: int,
    k: int,
    *,
    n_dev: float = 16,
    hw: HardwareProfile = H100_SXM,
    fused_ffn: bool = True,
    weight_bits: int = 16,
) -> float:
    """Expected decode-throughput ratio of speculative verify over
    one-token-at-a-time decode on the MoE-layer roofline: committed
    tokens per round (``expected_verify_tokens``) divided by the verify
    round's cost relative to a single decode step. >1 exactly when the
    per-round token gain outruns the (sub-linear, memory-bound) cost of
    scoring ``spec_k + 1`` rows at once — the model-side version of the
    measured ``serve/spec/{on,off}`` rows in ``BENCH_serve.json``. Draft
    cost is not included (the n-gram drafter is host-side and free; a
    draft model adds its own, much smaller, roofline)."""
    dec = spec_verify_latency(1, d, f, e, k, n_dev=n_dev, hw=hw,
                              fused_ffn=fused_ffn, weight_bits=weight_bits)
    ver = spec_verify_latency(spec_k + 1, d, f, e, k, n_dev=n_dev, hw=hw,
                              fused_ffn=fused_ffn, weight_bits=weight_bits)
    return expected_verify_tokens(accept_rate, spec_k) * dec / ver


# ---------------------------------------------------------------------------
# runtime hooks (called from moe_parallel / lm with static shapes)
# ---------------------------------------------------------------------------

def _tp_group_size(cfg, mesh) -> int:
    """TP group extent under the given config/mesh (1 without a mesh).

    A two-level mesh spreads the TP group over a
    ("node", "model") axis tuple; the group size is the product."""
    if mesh is None or not getattr(mesh, "axis_names", ()):
        return 1
    tp = cfg.axes(mesh)["tp"]
    if not tp:
        return 1
    size = 1
    for ax in (tp if isinstance(tp, tuple) else (tp,)):
        size *= int(mesh.shape[ax])
    return size


def _record_mode(mode: str, source: str, cost_s=None) -> str:
    """Publish a layer-mode decision and pass it through. The port decides
    at every forward (eager), so the counter counts forwards, where the
    JAX package's counts traces."""
    obs.registry.counter(
        "repro_autotune_mode_total",
        "per-layer parallel-mode decisions, by mode and decision source",
        labels=("mode", "source")).labels(mode, source).inc()
    if cost_s is not None:
        obs.registry.gauge(
            "repro_autotune_predicted_latency_seconds",
            "roofline-predicted layer latency for the chosen mode",
            labels=("mode",)).labels(mode).set(float(cost_s))
    return mode


def resolve_layer_mode(
    tokens: int,
    *,
    d: int,
    f: int,
    e: int,
    k: int,
    cfg,
    mesh,
    layer_idx: Optional[int] = None,
) -> str:
    """Per-layer mode decision for ``ParallelConfig.mode == "auto"``.

    Precedence: ``cfg.forced_layer_mode`` > ``cfg.layer_mode_plan`` (indexed
    by ``layer_idx`` modulo plan length) > the roofline chooser. With a
    ``cfg.hetero_plan`` whose latencies cover the TP group, the chooser
    evaluates the *uneven-split* roofline (``layer_latency_uneven``)
    — the max over devices under their actual Eq. 1/2 shares —
    instead of the ``effective_devices`` scalar approximation used for bare
    ``cfg.device_latencies``. The fused FFN's HBM cost is modelled: the
    port's islands always run it.
    Weight bytes are priced at the quantized width: the
    plan's per-class ``expert_bits`` when it carries them, else 8 bits
    under ``cfg.quant`` int8/fp8, else 16.
    With a ``cfg.topology`` both rooflines price the token
    and weight collectives per interconnect level (intra-node vs
    inter-node), so a slow cross-node fabric pulls the crossover toward
    data-centric — the per-node weight staging amortises the slow links.
    """
    if cfg.forced_layer_mode is not None:
        return _record_mode(cfg.forced_layer_mode, "forced")
    if cfg.layer_mode_plan and layer_idx is not None:
        planned = cfg.layer_mode_plan[layer_idx % len(cfg.layer_mode_plan)]
        if planned is not None:
            return _record_mode(planned, "plan")
    from repro_torch.quant.core import quant_bits

    topo = getattr(cfg, "topology", None)
    hw = (H100_SXM if topo is None
          else dataclasses.replace(H100_SXM, topology=topo))
    n_dev = float(_tp_group_size(cfg, mesh))
    bits = quant_bits(getattr(cfg, "quant", "none"))
    plan = getattr(cfg, "hetero_plan", None)
    plan_lat = (None if plan is None
                else (plan.tp_latencies or plan.proxy_latencies))
    if plan_lat is not None and n_dev > 1 and len(plan_lat) == int(n_dev):
        lat = list(plan_lat)
        # Eq. 1 token weights; Eq. 2 hidden columns if the plan carries them.
        inv = [1.0 / t for t in lat]
        hs = (list(plan.hidden_splits)
              if plan.hidden_splits is not None else inv)
        wb = (list(plan.expert_bits)
              if plan.expert_bits is not None
              and len(plan.expert_bits) == len(lat) else bits)
        costs = {
            m: layer_latency_uneven(
                m, tokens, d, f, e, k, lat,
                token_shares=inv, hidden_shares=hs, hw=hw, weight_bits=wb,
            )
            for m in CHOOSABLE_MODES
        }
        best = min(costs, key=costs.get)
        return _record_mode(best, "roofline_uneven", cost_s=costs[best])
    if cfg.device_latencies:
        lat = list(cfg.device_latencies)
        # Exactly one latency per group member: use them directly. A shorter
        # (or longer) list is a representative sample of the fleet mix —
        # scale its effective fraction to the group size rather than
        # silently modelling an n_dev-wide group as len(lat) devices.
        if len(lat) == int(n_dev):
            n_dev = effective_devices(lat)
        else:
            n_dev = n_dev * effective_devices(lat) / len(lat)
    return _record_mode(choose_mode(tokens, d, f, e, k, n_dev=n_dev, hw=hw,
                                    weight_bits=bits), "roofline")


def plan_layer_modes(model_cfg, cfg, mesh, tokens: int) -> Tuple[Optional[str], ...]:
    """Whole-model plan: one entry per period position (None = not MoE).

    Pin the result into ``ParallelConfig.layer_mode_plan`` to freeze the
    decision (e.g. for the dry-run, or to ship a serving config that never
    re-derives it).
    """
    if model_cfg.moe is None:
        return ()
    m = model_cfg.moe
    out = []
    for pos in range(model_cfg.period):
        if not model_cfg.is_moe_layer(pos):
            out.append(None)
            continue
        out.append(resolve_layer_mode(
            tokens,
            d=model_cfg.d_model, f=m.d_ff, e=m.num_experts, k=m.top_k,
            cfg=cfg, mesh=mesh, layer_idx=pos,
        ))
    return tuple(out)
