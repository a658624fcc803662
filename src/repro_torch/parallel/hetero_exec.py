"""Per-device-program heterogeneous MoE execution (paper §4.4 run for real;
counterpart of ``repro.parallel.hetero_exec``).

A heterogeneous fleet cannot run one SPMD program: each device class runs
shapes of its own. So the execution model is one *program per device*,
each with shapes cut from a ``core.hetero.HeteroPlan``:

  data-centric  — device i's program takes its Eq. 1 token shard
                  (``token_counts[i]`` rows, padded up to ``token_quantum``
                  with a masked tail) against the full expert weights;
                  the shard outputs concatenate back to the global batch.
  model-centric — device i's program takes all tokens against its Eq. 2
                  hidden slice (``hidden_splits[i]`` columns, a quantum
                  multiple by construction, so every kernel tile is whole
                  and no device computes past its h_i); partial outputs
                  sum.

A device class with ``expert_bits`` 8 holds its weights as block-wise int8
payloads and scales (``quant.core.quantize_ffn``) and runs the kernels'
8-bit branches. The hidden slices are cut once, at construction, as
contiguous tensors of their own: the kernels need contiguous operands on
16-byte boundaries, which a strided slice ``w[:, :, a:b]`` is not.

``timed_step`` times each device program and scales its time by the
plan's relative latency: a *simulated-skew mesh*. The kernels run for real
at the uneven shapes on this one device, and device i's clock runs
``t_i / t_min`` slower; the synchronous step ends at the slowest device
(the barrier). On the card the programs run one after another, timed with
CUDA events.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common import round_up
from repro_torch.core import espec
from repro_torch.core.hetero import HeteroPlan
from repro_torch.core.reindex import build_reindex
from repro_torch.core.routing import route
from repro_torch.parallel.cache import tree_bytes
from repro_torch.quant.core import quantize_ffn


class HeteroStep(NamedTuple):
    """One executed uneven step: output, each device program's best
    seconds, and the simulated-skew synchronous latency (their max, each
    scaled by its skew)."""
    y: torch.Tensor
    device_times_s: tuple
    step_latency_s: float


def _ffn(x, ri, params, *, act, glu):
    if glu:
        scales = None
        if "w_gate_scale" in params:
            scales = (params["w_gate_scale"], params["w_up_scale"],
                      params["w_down_scale"])
        return espec.moe_glu(x, ri, params["w_gate"], params["w_up"],
                             params["w_down"], scales=scales, act=act)
    scales = None
    if "w1_scale" in params:
        scales = (params["w1_scale"], params["w2_scale"])
    return espec.moe_mlp(x, ri, params["w1"], params.get("b1"), params["w2"],
                         params.get("b2"), scales=scales, act=act)


def _slice(w, sl, dim):
    return None if w is None else w.narrow(dim, sl.start,
                                           sl.stop - sl.start).contiguous()


class HeteroExecutor:
    """Per-device programs for one MoE FFN layer under a HeteroPlan.

    ``params`` is the espec-style dict ('router' + GLU or MLP weights with
    the FULL hidden width; the slicing happens here). ``mode`` picks the
    equation the devices execute: "data_centric" needs
    ``plan.token_counts``, "model_centric" needs ``plan.hidden_splits``.
    A class marked 8 in ``plan.expert_bits`` holds its weights quantized
    (``quant_mode``, ``quant_tile``); the data-centric classes share one
    quantized copy of the whole weights, the model-centric ones quantize
    their own slices."""

    def __init__(self, params: dict, *, num_experts: int, top_k: int,
                 act: str, glu: bool, plan: HeteroPlan, mode: str,
                 blk: int = 128, quant_mode: str = "int8",
                 quant_tile: int = 128):
        self.plan = plan
        self.mode = mode
        self.glu = glu
        self._route_args = (params["router"], top_k, num_experts, blk, act)
        t = np.asarray(plan.proxy_latencies, np.float64)
        self.skews = tuple(float(v) for v in t / t.min())
        splits = (plan.token_counts if mode == "data_centric"
                  else plan.hidden_splits)
        bits = plan.expert_bits or (16,) * len(splits or ())
        if splits is not None and len(bits) != len(splits):
            raise ValueError(
                f"expert_bits has {len(bits)} entries but the executed "
                f"{mode} split has {len(splits)} device programs")
        shared_q = (quantize_ffn(params, mode=quant_mode, tile=quant_tile)
                    if mode == "data_centric" and 8 in bits else None)

        def class_params(i, p_i):
            if bits[i] != 8:
                return p_i
            if shared_q is not None:
                return shared_q
            return quantize_ffn(p_i, mode=quant_mode, tile=quant_tile)

        self._programs = []  # [(device params, shard meta)]
        if mode == "data_centric":
            if plan.token_counts is None:
                raise ValueError("data_centric needs plan.token_counts")
            q = plan.token_quantum
            off = 0
            for i, b_i in enumerate(plan.token_counts):
                rows = max(round_up(b_i, q), q)
                self._programs.append((class_params(i, params),
                                       (off, b_i, rows)))
                off += b_i
        elif mode == "model_centric":
            if plan.hidden_splits is None:
                raise ValueError("model_centric needs plan.hidden_splits")
            off = 0
            for i, h_i in enumerate(plan.hidden_splits):
                sl = slice(off, off + h_i)
                if glu:
                    p_i = {"router": params["router"],
                           "w_gate": _slice(params["w_gate"], sl, 2),
                           "w_up": _slice(params["w_up"], sl, 2),
                           "w_down": _slice(params["w_down"], sl, 1)}
                else:
                    b2 = params.get("b2")
                    p_i = {"router": params["router"],
                           "w1": _slice(params["w1"], sl, 2),
                           "b1": _slice(params.get("b1"), sl, 1),
                           "w2": _slice(params["w2"], sl, 1),
                           # partial-sum bias: device 0 only, like the
                           # island's _mask_rank0 (no n_dev-fold bias)
                           "b2": (None if b2 is None else
                                  b2 if off == 0 else torch.zeros_like(b2))}
                self._programs.append((class_params(i, p_i), (off, h_i, None)))
                off += h_i
        else:
            raise ValueError(mode)

    def device_param_bytes(self) -> tuple:
        """Each device's expert-weight bytes (router excluded): an int8
        class holds about a quarter of the f32 bytes plus its scales."""
        return tuple(tree_bytes({k: v for k, v in p.items() if k != "router"})
                     for p, _ in self._programs)

    # -- execution ----------------------------------------------------------

    def _layer(self, x, p, n_valid=None):
        router, top_k, num_experts, blk, act = self._route_args
        vm = None
        if n_valid is not None and n_valid != x.shape[0]:
            vm = torch.arange(x.shape[0], device=x.device) < n_valid
        r = route(x, router, top_k, valid_mask=vm)
        ri = build_reindex(r.expert_idx, r.gates, num_experts, blk)
        return _ffn(x, ri, p, act=act, glu=self.glu)

    def device_input(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Device i's input: its padded token shard, or all of x."""
        _, meta = self._programs[i]
        if self.mode != "data_centric":
            return x
        off, b_i, rows = meta
        shard = x[off: off + b_i]
        if rows != b_i:
            shard = torch.cat([shard, x.new_zeros(rows - b_i, x.shape[1])])
        return shard

    def run_device(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Device i's program on the global tokens x (its raw output: the
        padded shard's rows, or its partial sum)."""
        p, meta = self._programs[i]
        n_valid = meta[1] if self.mode == "data_centric" else None
        return self._layer(self.device_input(i, x), p, n_valid)

    def device_params(self, i: int) -> dict:
        return self._programs[i][0]

    def _combine(self, outs) -> torch.Tensor:
        """Eq. 1 shards concatenate (each dropping its pad tail), Eq. 2
        partials sum over the hidden."""
        if self.mode == "data_centric":
            return torch.cat([o[:meta[1]]
                              for o, (_, meta) in zip(outs, self._programs)])
        y = outs[0]
        for o in outs[1:]:
            y = y + o
        return y

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Execute the uneven step (no timing): x (N, D) -> y (N, D)."""
        return self._combine([self.run_device(i, x)
                              for i in range(len(self._programs))])

    def timed_step(self, x: torch.Tensor, *, rounds: int = 5,
                   warmup: bool = True) -> HeteroStep:
        """Run and time each device program; apply the simulated skew.

        Device i's best (min over rounds) time is scaled by ``t_i/t_min``;
        the step ends at the slowest device. Min, not median: the programs
        run one after another on one device, so load spikes are one-sided
        noise. On the card each round is timed with CUDA events after a
        ``torch.cuda.synchronize()``; on the CPU with the host clock.
        ``warmup=False`` skips the untimed first pass, for callers that
        interleave several timed steps and have warmed every program."""
        n = len(self._programs)
        cuda = x.device.type == "cuda"
        outs = [None] * n
        if warmup:
            outs = [self.run_device(i, x) for i in range(n)]
        times = [[] for _ in range(n)]
        for _ in range(rounds):
            for i in range(n):
                if cuda:
                    torch.cuda.synchronize(x.device)
                    t0 = torch.cuda.Event(enable_timing=True)
                    t1 = torch.cuda.Event(enable_timing=True)
                    t0.record()
                    outs[i] = self.run_device(i, x)
                    t1.record()
                    t1.synchronize()
                    times[i].append(t0.elapsed_time(t1) / 1e3)
                else:
                    t0 = time.perf_counter()
                    outs[i] = self.run_device(i, x)
                    times[i].append(time.perf_counter() - t0)
        best = tuple(float(np.min(t)) for t in times)
        step = max(m * s for m, s in zip(best, self.skews))
        return HeteroStep(y=self._combine(outs), device_times_s=best,
                          step_latency_s=step)
