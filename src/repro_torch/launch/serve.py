"""Continuous-batching serving engines (counterpart of
``repro.launch.serve``'s ``BatchedServer``, ``PagedServer``,
``reference_stream`` and their CLI, with speculative decoding attached to
the paged engine by ``launch.spec.SpecDecoder``).

``BatchedServer`` (the CLI's default) holds the dense KV rectangle
``(slots, max_seq)`` and spends one full-batch macro-step on every prompt
token; ``reference_stream`` is its batch-1 ground truth. ``PagedServer``
(``--paged``): every occupied slot advances one token per decode
macro-step over the shared KV page pool; admission is by free-page budget
(worst-case pages reserved up front, so FIFO decode never starves the pool
mid-request); prompts prefill in batch-1 chunks interleaved with the
decode steps, with pages granted a chunk's worth at a time and on demand
at decode page boundaries. A request decodes greedily at ``temperature``
0, else by seeded categorical sampling (``next_token``; keys from
``(seed, len(out))`` only, drawn on the logits' device by
``launch.sampling``), so its stream is the same on every engine.
``--quant int8|fp8``
serves block-wise 8-bit expert weights (quantized layer by layer as the
model is drawn) on either engine, and ``--kv-quant int8`` int8 KV pages
with per-row scales (``--paged`` only), each through the kernels' 8-bit
branches.

``--spec-ngram`` / ``--spec-draft ARCH`` (``--paged`` only) verify drafted
tokens in one multi-token forward a slot (``launch.spec``).

The paged engine shares full prompt pages across requests through a
copy-on-write radix index (``--prefix-cache``), splits its slots into
prefill and decode roles that hand finished prompts over by page table
(``--disagg``), and survives injected faults (``--fault-spec``, a
``runtime.faults`` plan): request-level aborts with bounded retries, the
NaN watchdog, engine recovery, priority preemption, deadlines and device
dropout; ``--audit`` checks the page books after every scheduler step.

Every LM stack of the registry serves on both engines but musicgen-large:
MoE stacks (MLP experts too), dense and hybrid (Mamba + attention,
jamba-1.5-large-398b) stacks, xLSTM (xlstm-350m) and paligemma-3b's
token prompts (no image prefix, as the JAX engines serve it); a slot's
recurrent state is zeroed whenever the slot is reused
(``lm.reset_slot``). Speculation and the prefix cache need an
all-attention stack and refuse the others. musicgen-large (EnCodec
frames, 4 codebook heads) raises ``NotImplementedError``
(``lm.check_servable``), as no JAX engine serves it; its dense prefill
and decode steps are ``launch.steps``'.

On a mesh (``mesh=``, the CLI's ``--mesh`` with ``--mode``,
``--cache-layers``, ``--topology`` and ``--overlap-dispatch``) both
engines and ``reference_stream`` run the LM's mesh forward: every rank
runs the same host scheduler on the same logits, gathered over the
slots. The dense engine holds its block of the dense cache (its slots,
and its K/V heads where they split over "tp"). The paged engine holds
every page with its K/V heads (``lm.paged_cache_specs``), so the host
pool's page ids are global and any slot reads any page, and its block
of the slots' recurrent state; the prefill chunks run whole on every
rank. Its decisions agree on every rank: the drawn tokens and their
finiteness are rank 0's, and so is every reading of the engine clock
(deadlines, ``trace_t``). Every feature runs there: the prefix cache,
disaggregation, int8 pages, page shares, faults and recovery, and
speculation.

The CLI's ``--hetero-latencies`` (with ``--hetero-tp-latencies``)
builds an Eq. 1/2 ``core.hetero.HeteroPlan``, as the JAX CLI does: the
dense engine on a mesh takes its slot shares as padded slots of which
``valid_slots`` are scheduled, the paged one its page-pool shares, and
the weights are drawn at its padded hidden width. ``--topology`` splits
``--mesh``'s model extent into ("node", "model") for the hierarchical
schedule; ``--overlap-dispatch`` (with ``--cache-layers``) runs the
overlap schedule in the serving forwards.

Observability (``obs``; DESIGN.md §12): the paged engine records the
spans ``serve.run``, ``serve.prefill_chunk``, ``serve.handoff`` and
``serve.decode`` (with the ``repro_serve_decode_step_seconds``
histogram) and the instants ``serve.first_token`` and ``serve.token``,
mirrors every scheduler event into ``obs.events`` with its reason, and
registers itself, its pool and its prefix index for snapshot polling
(``obs_metrics``), as the JAX engine does. With
``pcfg.collect_router_stats`` and an MoE config every step's router
stats go to a ``RouterStatsDrain`` (phase "serve") without a host copy,
flushed at each dump; the dense engine drains its steps' stats the same
way. On a mesh only rank 0 drains (the stats are global on every rank)
and the CLI turns the recorders on only there. The serve CLI's
``--metrics``, ``--metrics-interval``, ``--trace-out`` and
``--events-out`` are the JAX CLI's: stats are collected with ``--paged``
and an MoE config, the registry is dumped at exit (and every N
scheduler steps), and the trace's span coverage, TTFT and TPOT are
printed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch import obs
from repro_torch.common import cdiv, resolve_device, torch_dtype, tree_leaves
from repro_torch.core import hetero as hetero_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sampling
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train as train_lib
from repro_torch.launch.inputs import activation_spec
from repro_torch.models import lm
from repro_torch.parallel.cache import PagePool, PrefixIndex, page_shares
from repro_torch.parallel.sharding import ParallelConfig
from repro_torch.runtime import faults as faults_lib


@dataclass
class Request:
    """One serving request: prompt tokens in, up to ``max_new`` tokens
    out, chosen greedily at ``temperature`` 0 (the default) or drawn
    categorically under the request's own ``seed``.

    Robustness fields (the paged engine): ``priority`` orders preemption
    under page pressure (lower is preempted first); ``deadline_s`` bounds
    the time from ``submit`` on the engine's clock; a faulted request
    retries up to the engine's ``max_retries``, ``aborts`` and
    ``preemptions`` counting the restarts. A retry clears ``out`` and
    replays from the prompt: keys derive only from ``(seed, len(out))``,
    so the replay is token-identical. A request that failed for good
    carries the reason in ``error``."""
    rid: int
    prompt: np.ndarray           # (S_prompt,)
    max_new: int
    out: list = field(default_factory=list)
    temperature: float = 0.0     # 0 = greedy argmax
    seed: int = 0                # per-request sampling seed
    priority: int = 0            # higher admits over lower under pressure
    deadline_s: Optional[float] = None   # budget from submit (engine clock)
    submit_t: float = 0.0        # stamped by submit()
    aborts: int = 0              # fault / NaN retries consumed
    preemptions: int = 0         # page-pressure evictions (not retries)
    error: Optional[str] = None  # why the request failed for good


def argmax_token(logits_row) -> int:
    """The engine-wide greedy convention: upcast the row to f32, then
    argmax; ties resolve to the lowest index."""
    if isinstance(logits_row, torch.Tensor):
        logits_row = logits_row.detach().float().cpu().numpy()
    row = np.asarray(logits_row, np.float32).reshape(-1)
    return int(np.argmax(row))


def draw_rows(rows: torch.Tensor, reqs: list, steps=None,
              mesh=None) -> tuple:
    """``next_token`` of every row of ``rows`` (B, V), row ``i`` for
    ``reqs[i]`` at step ``steps[i]`` (default ``len(reqs[i].out)``), and
    whether the row is finite, both computed on the rows' device and
    brought to the host in ONE copy: (tokens (B,) int64, finite (B,)
    bool). A None entry of ``reqs`` is drawn greedily and unused. On a
    ``mesh`` both are rank 0's on every rank (``Mesh.broadcast0``), so
    every rank's scheduler takes the same decisions even where ranks
    computed a row with different rounding."""
    if steps is None:
        steps = [len(r.out) if r else 0 for r in reqs]
    drawn = sampling.sample_rows(
        rows, [r.seed if r else 0 for r in reqs], steps,
        [r.temperature if r else 0.0 for r in reqs])
    host = torch.stack([drawn, torch.isfinite(rows).all(-1).long()])
    if mesh is not None:
        mesh.broadcast0(host)
    host = host.cpu().numpy()
    return host[0], host[1].astype(bool)


def next_token(logits_row, req: Request) -> int:
    """Engine-independent next-token selection: greedy at ``temperature
    <= 0`` (``argmax_token``), else a categorical draw from ``row /
    temperature`` at the key ``fold_in(PRNGKey(req.seed), len(req.out))``
    (``launch.sampling``, ``jax.random``'s bits). Keys derive ONLY from
    ``(seed, len(out))``, so a request's stream is a pure function of its
    own logits and seed on every engine, the speculative verify included
    (it appends each accepted token before drawing the next)."""
    if req.temperature <= 0.0:
        return argmax_token(logits_row)
    row = (logits_row if isinstance(logits_row, torch.Tensor)
           else torch.from_numpy(np.asarray(logits_row, np.float32)))
    return int(draw_rows(row.reshape(1, -1), [req])[0][0])


def reference_stream(cfg, pcfg, params, req: Request, *, max_seq: int,
                     step=None, mesh=None) -> list[int]:
    """One-request-at-a-time dense-cache reference stream: batch-1 prefill
    (token by token) then decode through ``next_token``, on the device the
    params lie on: the ground truth both batched servers are held to, for
    greedy and sampled requests. On a ``mesh``, params are this rank's
    shards (``lm.param_specs``). The reference collects no router
    telemetry (``collect_router_stats`` is switched off for its step)."""
    lm.check_servable(cfg)
    device = params["embed"].device
    pcfg = dataclasses.replace(pcfg, collect_router_stats=False)
    if step is None:
        step = steps_lib.make_serve_step(
            cfg, pcfg, mesh=mesh, batch_shape3=(1, 1, cfg.d_model))
    ref = dataclasses.replace(req, out=[])   # keys follow len(ref.out)
    cache = lm.init_cache(cfg, 1, max_seq, device, pcfg=pcfg, mesh=mesh)

    def feed(tok):
        nonlocal cache
        logits, cache = step(
            params, {"tokens": torch.tensor([[tok]], dtype=torch.int32,
                                            device=device)}, cache)[:2]
        return logits[0, -1]

    for tok in ref.prompt:
        logits = feed(int(tok))
    ref.out.append(next_token(logits, ref))
    while len(ref.out) < ref.max_new:
        ref.out.append(next_token(feed(ref.out[-1]), ref))
    return ref.out


def greedy_reference(cfg, pcfg, params, prompt, max_new, *, max_seq: int,
                     step=None, mesh=None) -> list[int]:
    """Greedy ``reference_stream`` of one prompt."""
    return reference_stream(
        cfg, pcfg, params,
        Request(rid=-1, prompt=np.asarray(prompt), max_new=max_new),
        max_seq=max_seq, step=step, mesh=mesh)


def _check_request(req: Request):
    if len(req.prompt) < 1 or req.max_new < 1:
        raise ValueError(f"request {req.rid}: empty prompt or max_new")


# ---------------------------------------------------------------------------
# dense engine
# ---------------------------------------------------------------------------

@dataclass
class _Slot:
    req: Request
    pos: int = 0        # prompt tokens consumed


class BatchedServer:
    """Dense-cache continuous batching: the KV rectangle ``(num_slots,
    max_seq)`` is allocated up front (the memory over-allocation the paged
    engine exists to kill) and every prompt token of every request costs
    one full-batch macro-step. Only ``valid_slots`` (default: all) are
    schedulable. The cache and lengths live on ``device`` (the GPU unless
    ``device="cpu"``); the schedule lives on the host. On a ``mesh``:
    params are this rank's shards, the cache its block
    (``lm.init_cache(mesh=)``), and every rank schedules alike from the
    gathered logits. With ``pcfg.collect_router_stats`` and an MoE config
    each macro-step's router stats go to ``router_drain`` (phase
    "serve"; rank 0's on a mesh), flushed by ``run`` at its end."""

    def __init__(self, cfg, pcfg, *, num_slots: int, max_seq: int, params,
                 valid_slots: Optional[list] = None, device=None,
                 mesh=None):
        lm.check_servable(cfg)
        lm.check_mesh(cfg, pcfg, mesh)
        self.cfg, self.pcfg, self.mesh = cfg, pcfg, mesh
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"server runs on {self.device}")
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.params = params
        shape3 = (num_slots, 1, cfg.d_model)
        self.cache = lm.init_cache(cfg, num_slots, max_seq, self.device,
                                   pcfg=pcfg, mesh=mesh)
        self.serve_step = steps_lib.make_serve_step(
            cfg, pcfg, mesh=mesh, batch_shape3=shape3)
        # this rank's slots: [lo, lo + n) of the global ones
        self._slots_lo, self._slots_n = 0, num_slots
        if mesh is not None:
            axes = activation_spec(shape3, pcfg, mesh)[0]
            self._slots_n = num_slots // mesh.size(axes)
            self._slots_lo = mesh.index(axes) * self._slots_n
        self.slots: list[Optional[_Slot]] = [None] * num_slots
        self.queue: deque[Request] = deque()
        self.free = sorted(valid_slots if valid_slots is not None
                           else range(num_slots), reverse=True)
        self.decode_times_s: list = []
        self.ttft_s: dict = {}           # rid -> first-token latency
        self.admissions = 0
        self._run_t0 = 0.0
        self.router_drain = _router_drain(cfg, pcfg, mesh)

    def kv_bytes(self) -> int:
        """Device bytes of the dense KV rectangle (on a mesh, of this
        rank's block of it)."""
        return lm.cache_bytes(self.cache)

    def submit(self, req: Request):
        _check_request(req)
        if len(req.prompt) + req.max_new - 1 > self.max_seq:
            raise ValueError(
                f"request {req.rid} needs {len(req.prompt) + req.max_new - 1}"
                f" cache rows > max_seq {self.max_seq}")
        self.queue.append(req)

    def _admit(self):
        while self.free and self.queue:
            slot = self.free.pop()
            req = self.queue.popleft()
            local = slot - self._slots_lo
            if 0 <= local < self._slots_n:
                self.cache = lm.reset_slot(self.cfg, self.cache, local)
            self.slots[slot] = _Slot(req)
            self.admissions += 1

    def _macro_step(self) -> list[Request]:
        tokens = np.zeros((self.num_slots, 1), np.int32)
        active = np.zeros((self.num_slots,), bool)
        for slot, st in enumerate(self.slots):
            if st is None:
                continue
            active[slot] = True
            tokens[slot, 0] = (st.req.prompt[st.pos]
                               if st.pos < len(st.req.prompt)
                               else st.req.out[-1])
        t0 = time.perf_counter()
        out = self.serve_step(
            self.params,
            {"tokens": torch.from_numpy(tokens).to(self.device),
             "active": torch.from_numpy(active).to(self.device)},
            self.cache)
        logits, self.cache = out[:2]
        if self.router_drain is not None:
            self.router_drain.push(out[2])
        emit = [st.req if st is not None
                and st.pos + 1 >= len(st.req.prompt) else None
                for st in self.slots]
        nxt, _ = draw_rows(logits[:, -1], emit)
        self.decode_times_s.append(time.perf_counter() - t0)
        done = []
        for slot, st in enumerate(self.slots):
            if st is None:
                continue
            st.pos += 1
            if st.pos >= len(st.req.prompt):
                if not st.req.out:
                    self.ttft_s[st.req.rid] = \
                        time.perf_counter() - self._run_t0
                st.req.out.append(int(nxt[slot]))
                if len(st.req.out) >= st.req.max_new:
                    done.append(st.req)
                    self.slots[slot] = None
                    self.free.append(slot)
        return done

    def run(self, max_steps: int = 100000) -> list[Request]:
        """Drive admission + macro-steps until every request has finished."""
        done: list[Request] = []
        steps = 0
        self._run_t0 = time.perf_counter()
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self._admit()
            done.extend(self._macro_step())
            steps += 1
        if self.router_drain is not None:
            self.router_drain.flush()
        return done


def _router_drain(cfg, pcfg, mesh):
    """An engine's router-stats drain: with ``collect_router_stats``, an
    MoE config, and on a mesh rank 0 only (the stats are global)."""
    if not pcfg.collect_router_stats or cfg.moe is None:
        return None
    if mesh is not None and not mesh_lib.is_rank0():
        return None
    return obs.RouterStatsDrain(obs.registry, cfg.moe.num_experts,
                                phase="serve")


# ---------------------------------------------------------------------------
# paged engine
# ---------------------------------------------------------------------------

@dataclass
class _PagedSlot:
    req: Request
    group: int           # page-pool group the slot's budget comes from
    order: int           # admission sequence (FIFO prefill priority)
    need: int            # worst-case pages for the request
    reserved: int        # pages reserved from the pool at admission
    pages: list = field(default_factory=list)  # phys page per logical page
    pos: int = 0         # prompt tokens consumed
    length: int = 0      # tokens resident in the paged cache
    reclaimed: int = 0   # leading logical pages released behind the window
    allocated: int = 0   # pool.alloc calls (reservations consumed)
    matched: int = 0     # prefix-cache pages mapped in at refcount + 1


class _AgreedClock:
    """Rank 0's reading of ``clock`` on every rank of ``mesh``: each call
    reads the clock and broadcasts rank 0's value (a collective, which
    every rank's identical scheduler reaches at the same point), so a
    deadline expires at the same step on every rank and the collectives
    of the steps stay in step."""

    def __init__(self, clock, mesh, device):
        self.clock, self.mesh, self.device = clock, mesh, device

    def __call__(self) -> float:
        t = torch.tensor([self.clock()], dtype=torch.float64,
                         device=self.device)
        return float(self.mesh.broadcast0(t)[0])


def derive_roles(token_counts) -> list:
    """Disaggregated prefill/decode role per device class: the class(es)
    with the largest Eq. 1 token share prefill, the rest decode. A uniform
    (or single-class) plan gives ``"both"`` everywhere, which is the
    single-loop engine."""
    counts = list(token_counts)
    if len(set(counts)) < 2:
        return ["both"] * len(counts)
    top = max(counts)
    return ["prefill" if c == top else "decode" for c in counts]


class PagedServer:
    """Continuous batching over the paged KV cache.

    A request is admitted only when its worst-case page count
    ``ceil((prompt + max_new - 1) / page_size)`` can be reserved from its
    slot's group; prefill grants a chunk's worth of pages before each
    ``prefill_chunk``-token batch-1 chunk, decode one page per boundary
    crossing; on all-windowed stacks pages wholly behind the window return
    to the pool mid-request. The K/V pools and lengths live on ``device``
    (the GPU unless ``device="cpu"``); tables and the schedule live on the
    host. ``kv_quant="int8"``: int8 pools with per-(row, kv head) f32
    scales, admission budgeted in the smaller int8 page bytes.

    ``prefix_cache``: admission maps the longest cached run of full prompt
    pages (``PrefixIndex``) into the slot at refcount + 1 and prefills only
    the rest; a shared page about to be written is copied first
    (``_cow_page``). ``plan`` (any object with ``token_counts``, a hetero
    plan's Eq. 1 shares): per-group page budgets (``page_shares``), slot
    ``s`` in group ``s * groups // num_slots``. ``disagg``: prefill-role
    slots hand finished prompts to decode-role slots by moving the table
    row and the length (``make_paged_handoff_step``), roles by
    ``derive_roles`` under a plan, else half and half.

    Robustness: a request has a ``priority`` (a higher head preempts the
    youngest lower-priority decoding request under page pressure), a
    ``deadline_s`` on ``clock`` and up to ``max_retries`` retries after a
    request-level fault or non-finite logits (the NaN watchdog, folded
    into the one device-to-host copy a step makes); failed requests land
    in ``failed``. Injected faults (``runtime.faults``: ``serve.prefill``,
    ``serve.prefill_logits``, ``serve.decode``, ``serve.logits``) abort
    and retry a slot, rebuild the steps (``_recover_engine``) or, on a
    device dropout, shrink the pool's groups (``_shrink``). ``audit``
    checks ``assert_page_invariants`` after every scheduler step.

    A ``launch.spec.SpecDecoder`` attaches itself as ``spec`` and then runs
    every decode tick. ``trace`` lists the scheduler's events as tuples:
    ``("admit", rid, slot)``, ``("prefill_chunk", rid, slot, n)``,
    ``("decode", slots)``, ``("transfer", rid, src, dst)``, ``("finish",
    rid, slot)``, ``("abort", rid, slot, reason)``, ``("preempt", rid,
    slot)``, ``("recover",)``, ``("shrink", survivors)``, ``("rollback",
    rid, slot, n)``, ``("spec_verify", rid, slot, n_valid, accepted)`` and
    ``("fail", rid, reason)``, as the JAX engine's ``trace`` yields them;
    ``trace_t`` holds the engine clock at each.

    On a ``mesh``: params are this rank's shards (``lm.param_specs``) and
    the cache its block (``lm.init_paged_cache(mesh=)``: every page, its
    K/V heads, its slots' recurrent state); every rank runs this
    scheduler alike, on rank 0's draws and clock readings (``draw_rows``,
    ``_AgreedClock``). A ``plan``'s Eq. 1 shares are page budgets, so its
    ``token_counts`` are dropped from the steps' ``pcfg`` (no slot row is
    masked), as the JAX engine drops them; its Eq. 2 widths stay.
    """

    def __init__(self, cfg, pcfg, *, num_slots: int, page_size: int,
                 num_pages: int, max_pages_per_slot: int, params,
                 prefill_chunk: int = 16, plan=None, kv_quant=None,
                 prefix_cache: bool = False, disagg: bool = False,
                 max_retries: int = 2, audit: bool = False,
                 clock=time.perf_counter, device=None, mesh=None):
        lm.check_servable(cfg)
        lm.check_mesh(cfg, pcfg, mesh)
        if pcfg.hetero_plan is not None:
            pcfg = dataclasses.replace(pcfg, hetero_plan=dataclasses.replace(
                pcfg.hetero_plan, token_counts=None, token_capacity=None))
        self.cfg, self.pcfg, self.mesh = cfg, pcfg, mesh
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"server runs on {self.device}")
        if mesh is not None and mesh.size(mesh.axis_names) > 1:
            clock = _AgreedClock(clock, mesh, self.device)
        self.max_retries = max_retries
        self.audit = audit
        self.clock = clock
        self.num_slots = num_slots
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self.prefill_chunk = prefill_chunk
        self.params = params
        self.kv_quant = None if kv_quant in (None, "none") else kv_quant
        self.cache = lm.init_paged_cache(cfg, num_slots, num_pages, page_size,
                                         self.device, kv_quant=self.kv_quant,
                                         pcfg=pcfg, mesh=mesh)
        # the slots whose recurrent state rows this rank holds
        self._held = lm.paged_slot_block(cfg, pcfg, mesh, num_slots)[1:]
        self.page_bytes = lm.paged_kv_page_bytes(cfg, page_size,
                                                 kv_quant=self.kv_quant)
        # each class's Eq. 1 weight, kept so a device dropout can re-derive
        # the shares and roles over the survivors
        self.class_weights = (list(plan.token_counts)
                              if plan is not None else [1])
        shares = None
        self.groups = [0] * num_slots
        if plan is not None:
            shares = page_shares(plan.token_counts, num_pages - 1)
            n_g = len(shares)
            if num_slots < n_g:
                raise ValueError(
                    f"{num_slots} slots cannot cover {n_g} device groups "
                    f"(a group without slots could never admit)")
            self.groups = [s * n_g // num_slots for s in range(num_slots)]
        self.pool = PagePool(num_pages, page_bytes=self.page_bytes,
                             shares=shares)
        # Window page reclamation: when EVERY attention layer is windowed,
        # a page wholly behind the window is dead and returns to the pool.
        attn_idx = [i for i in range(cfg.num_layers)
                    if cfg.layer_kind(i) == "attn"]
        self.reclaim_window = (
            cfg.window if cfg.window > 0 and attn_idx and all(
                cfg.attn_kind(i) == "local" for i in attn_idx)
            else None)
        # the prefix cache skips prompt pages, which holds only where pages
        # are a slot's whole state: every layer attention
        self.index = None
        if prefix_cache:
            if any(cfg.layer_kind(i) != "attn"
                   for i in range(cfg.num_layers)):
                raise ValueError(
                    "prefix_cache requires an all-attention stack: "
                    "recurrent layers keep per-slot state outside the KV "
                    "pages, so a shared prefix cannot be skipped")
            self.index = PrefixIndex(page_size)
        self.disagg = disagg
        self.roles = ["both"] * num_slots
        if disagg:
            if plan is not None:
                group_roles = derive_roles(plan.token_counts)
                self.roles = [group_roles[self.groups[s]]
                              for s in range(num_slots)]
            else:
                if num_slots < 2:
                    raise ValueError("disagg needs >= 2 slots")
                self.roles = ["prefill" if s < num_slots // 2 else "decode"
                              for s in range(num_slots)]
            if "prefill" in self.roles and "decode" not in self.roles:
                raise ValueError(
                    "disaggregated plan has prefill-only slots but no "
                    "decode-capable slot — finished prefills could never "
                    "hand off")
        self.spec = None                 # a SpecDecoder, when attached
        self.table = np.zeros((num_slots, max_pages_per_slot), np.int32)
        self._build_steps()
        self.slots: list[Optional[_PagedSlot]] = [None] * num_slots
        self.queue: deque[Request] = deque()
        self.free = sorted(range(num_slots), reverse=True)
        self.decode_times_s: list = []
        self.ttft_s: dict = {}           # rid -> first-token latency
        self.admissions = 0
        self.admission_log: list = []    # rids, in admission order
        self.trace: list[tuple] = []     # (name, *args) scheduler events
        self.trace_t: list = []          # the engine clock at each event
        self.transfers = 0
        self.failed: list[Request] = []  # permanently failed requests
        self.aborts = 0                  # fault / NaN slot aborts
        self.preemptions = 0             # page-pressure evictions
        self.engine_recoveries = 0       # step rebuilds
        self._order = 0
        self._run_t0 = 0.0
        # router telemetry: the steps' stats, pushed here and flushed at
        # each dump; periodic Prometheus dumps from run() (every
        # obs_dump_every scheduler steps; 0: at the end only)
        self.router_drain = _router_drain(cfg, pcfg, mesh)
        self.obs_dump_every = 0
        self.obs_dump_path: Optional[str] = None
        obs.maybe_register(self)
        obs.maybe_register(self.pool)
        if self.index is not None:
            obs.maybe_register(self.index)

    def _build_steps(self):
        """(Re)build the decode and prefill steps, at construction and in
        ``_recover_engine``. The handoff and page-copy steps are built on
        first use; an attached ``SpecDecoder`` rebuilds its score step."""
        kw = {"mesh": self.mesh, "num_slots": self.num_slots}
        self.serve_step = steps_lib.make_paged_serve_step(
            self.cfg, self.pcfg, self.page_size, **kw)
        self.prefill_step = steps_lib.make_paged_prefill_step(
            self.cfg, self.pcfg, self.page_size, **kw)
        self._handoff_step = None
        self._copy_step = None
        if self.spec is not None:
            self.spec.reset_steps()

    def _event(self, name: str, *args, reason: Optional[str] = None):
        """Record one scheduler event in ``trace``, and the engine clock at
        it in ``trace_t`` (the clock is read once an event, as the JAX
        engine reads it, so a deadline on a tick clock expires at the same
        step in both); mirrored into ``obs.events`` as ``serve.<name>``
        with its ``reason`` when the event log is on."""
        t = self.clock()
        self.trace_t.append(t)
        self.trace.append((name, *args))
        obs.events.emit(f"serve.{name}", reason=reason, t=t,
                        detail=list(args))

    def obs_metrics(self) -> dict:
        """Scheduler counters for registry snapshot polling."""
        return {
            "repro_serve_admissions_total": self.admissions,
            "repro_serve_transfers_total": self.transfers,
            "repro_serve_aborts_total": self.aborts,
            "repro_serve_preemptions_total": self.preemptions,
            "repro_serve_engine_recoveries_total": self.engine_recoveries,
            "repro_serve_failed_requests_total": len(self.failed),
            "repro_serve_queue_depth": len(self.queue),
            "repro_serve_live_slots": sum(
                s is not None for s in self.slots),
        }

    def _unpack_step(self, out):
        """A step's (result, cache): with ``collect_router_stats`` every
        step returns its router stats third, pushed onto the drain (no
        host copy)."""
        if self.pcfg.collect_router_stats:
            a, cache, rstats = out
            if self.router_drain is not None:
                self.router_drain.push(rstats)
            return a, cache
        return out

    def _dump_metrics(self):
        """Flush the router drain and write a Prometheus snapshot (the
        periodic in-run dumps; the CLI also dumps at exit)."""
        if self.router_drain is not None:
            self.router_drain.flush()
        if self.obs_dump_path:
            obs.dump_prometheus(obs.registry, self.obs_dump_path)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def kv_bytes(self) -> int:
        """Device bytes of the paged cache (on a mesh, of this rank's
        block: every page with its K/V heads)."""
        return lm.cache_bytes(self.cache)

    def _need_pages(self, req: Request) -> int:
        # cache rows written = prompt + fed-back outputs (the last
        # generated token is never fed back)
        return cdiv(len(req.prompt) + req.max_new - 1, self.page_size)

    def submit(self, req: Request):
        _check_request(req)
        need = self._need_pages(req)
        if need > self.max_pages_per_slot:
            raise ValueError(
                f"request {req.rid} needs {need} pages "
                f"> max_pages_per_slot {self.max_pages_per_slot}")
        if need > max(self.pool.shares):
            raise ValueError(
                f"request {req.rid} needs {need} pages > largest group "
                f"share {max(self.pool.shares)} — it could never admit "
                f"(FIFO would deadlock behind it)")
        req.submit_t = self.clock()
        self.queue.append(req)

    # -- scheduling ticks -----------------------------------------------------

    def _try_reserve_evicting(self, n: int, group: int) -> bool:
        """``try_reserve``, evicting LRU prefix-cache pages that only the
        index still holds until the reservation fits or the index runs
        dry."""
        while not self.pool.try_reserve(n, group):
            if self.index is None or not self.index.evict_lru(self.pool):
                return False
        return True

    def _admit(self):
        """Strict FIFO: the queue head admits as soon as a free
        prefill-capable slot's group can reserve its pages; nothing
        overtakes it. With the prefix cache on, the head's prompt is first
        matched against the index (at most ``(plen - 1) // page_size``
        pages, so one suffix token always prefills and gives the
        first-token logits), the matched pages forked (refcount + 1, no
        budget) and only the rest reserved. When no group can reserve, a
        strictly lower-priority decoding request is preempted and the head
        tried again."""
        while self.queue and self.free:
            req = self.queue[0]
            need = self._need_pages(req)
            matched: list = []
            if self.index is not None:
                matched = self.index.match(
                    req.prompt, (len(req.prompt) - 1) // self.page_size)
                if matched:
                    self.pool.fork(matched)
            reserve_n = need - len(matched)
            slot = None
            for s in reversed(self.free):        # lowest slot id first
                if self.roles[s] == "decode":
                    continue
                if self._try_reserve_evicting(reserve_n, self.groups[s]):
                    slot = s
                    break
            if slot is None:
                if matched:
                    self.pool.release(matched)   # undo the admission forks
                if self._preempt_for(req):
                    continue
                return
            self.queue.popleft()
            self.free.remove(slot)
            m = len(matched) * self.page_size
            self.cache = lm.reset_slot(self.cfg, self.cache, slot, length=m,
                                       held=self._held)
            self.slots[slot] = _PagedSlot(
                req, self.groups[slot], self._order, need,
                reserved=reserve_n, pages=list(matched), pos=m, length=m,
                matched=len(matched))
            self._order += 1
            self.admissions += 1
            self.admission_log.append(req.rid)
            self.table[slot, :] = 0
            self.table[slot, :len(matched)] = matched
            self._event("admit", req.rid, slot)

    def _cow_page(self, slot: int, st: _PagedSlot, j: int):
        """Copy-on-write guard: logical page ``j`` is about to be written
        but its physical page is shared. Reserve and allocate a private
        page, copy the payload on the device, repoint the table and
        surrender the shared reference. The engine's own writes land past
        the shared full prompt pages, so this is the pool-level guarantee,
        not a steady-state cost."""
        if not self._try_reserve_evicting(1, st.group):
            raise RuntimeError(
                f"slot {slot}: cannot reserve a CoW page for logical "
                f"page {j}")
        st.reserved += 1
        src = st.pages[j]
        dst = self.pool.cow(src, st.group)
        st.allocated += 1
        if self._copy_step is None:
            self._copy_step = steps_lib.make_page_copy_step(self.cfg)
        self.cache = self._copy_step(self.cache, src, dst)
        st.pages[j] = dst
        self.table[slot, j] = dst

    def _ensure_pages(self, slot: int, st: _PagedSlot, length: int):
        """Back every position below ``length`` with a physical page drawn
        from the request's admission reservation; the first page the coming
        write touches is copied first if it is shared."""
        j = st.length // self.page_size
        if j < len(st.pages) and st.pages[j] != 0 \
                and self.pool.refcount(st.pages[j]) > 1:
            self._cow_page(slot, st, j)
        while (length - 1) // self.page_size >= len(st.pages):
            st.pages.append(self.pool.alloc(st.group))
            st.allocated += 1
            self.table[slot, len(st.pages) - 1] = st.pages[-1]

    def _reclaim(self, slot: int, st: _PagedSlot):
        """Release pages wholly behind the attention window; the table
        entry drops to the sink (attention masks those positions)."""
        if self.reclaim_window is None:
            return
        dead = (st.length - self.reclaim_window) // self.page_size
        while st.reclaimed < dead:
            j = st.reclaimed
            self.pool.release([st.pages[j]], st.group)
            st.pages[j] = 0
            self.table[slot, j] = 0
            st.reclaimed += 1

    def _rollback(self, slot: int, n: int):
        """Un-write the slot's last ``n`` speculative cache rows by
        truncation only: shrink its device length (``lm.rollback_slot``;
        attention masks every row past it), pop the tail pages that no
        longer back a row back to the request's own reservation
        (``PagePool.rollback``, never the free budget) and zero their
        table entries. The popped pages lie past any prefix-matched prompt
        page, so they are never shared; a shared one would make the pool
        raise. The sampling key needs no rewind: keys derive from ``(seed,
        len(out))`` and rejected tokens were never appended."""
        st = self.slots[slot]
        if n <= 0:
            return
        new_len = st.length - n
        assert new_len >= len(st.req.prompt), (new_len, len(st.req.prompt))
        if self.reclaim_window is not None and st.reclaimed:
            # reclamation only ever runs at committed lengths (the spec
            # tick reclaims AFTER rollback), so no reclaimed page can
            # re-enter the rolled-back window
            assert st.reclaimed * self.page_size <= max(
                new_len - self.reclaim_window, 0), \
                "rollback would rewind into window-reclaimed pages"
        keep = cdiv(new_len, self.page_size)
        dropped = []
        while len(st.pages) > keep:
            p = st.pages.pop()
            self.table[slot, len(st.pages)] = 0
            if p != 0:
                dropped.append(p)
        if dropped:
            self.pool.rollback(dropped, st.group)
            st.allocated -= len(dropped)
        self.cache = lm.rollback_slot(self.cfg, self.cache, slot, new_len)
        st.length = new_len
        self._event("rollback", st.req.rid, slot, n,
                    reason="speculative rows rejected")

    def _finish(self, slot: int, st: _PagedSlot, done: list):
        done.append(st.req)
        self._release_slot(slot, st)
        self._event("finish", st.req.rid, slot)

    # -- failure handling -----------------------------------------------------

    def _release_slot(self, slot: int, st: _PagedSlot):
        """Return everything a slot holds to the pool: one reference per
        page still mapped (window-reclaimed entries are 0) and the
        unconsumed rest of its reservation."""
        self.pool.release([p for p in st.pages if p != 0], st.group,
                          unused_reserved=st.reserved - st.allocated)
        self.table[slot, :] = 0
        self.slots[slot] = None
        self.free.append(slot)
        if self.spec is not None:
            self.spec.forget(st.req.rid)

    def _fail_request(self, req: Request, reason: str):
        req.error = reason
        req.out.clear()
        self.failed.append(req)
        self._event("fail", req.rid, reason, reason=reason)

    def _abort_slot(self, slot: int, *, reason: str, requeue_at: int = 0,
                    count_retry: bool = True):
        """Tear a live request out of its slot: release its pages and
        reservation, clear its stream (keys derive from ``(seed,
        len(out))``, so the replay is token-identical), and queue it at
        ``requeue_at``, or fail it once its retries are spent. The retry
        re-admits through the prefix cache, so it prefills only the
        uncached rest."""
        st = self.slots[slot]
        req = st.req
        self._release_slot(slot, st)
        req.out.clear()
        self._event("abort", req.rid, slot, reason, reason=reason)
        if count_retry:
            req.aborts += 1
            self.aborts += 1
            if req.aborts > self.max_retries:
                self._fail_request(
                    req, f"retries exhausted ({self.max_retries}) "
                         f"after {reason}")
                return
        self.queue.insert(min(requeue_at, len(self.queue)), req)

    def _preempt_for(self, head: Request) -> bool:
        """Evict the lowest-priority (ties: youngest) decoding request
        strictly below ``head``'s priority and queue it right behind the
        head, with no retry charged; the strict inequality keeps
        equal-priority traffic from thrashing. False when there is no
        victim."""
        victims = [(st.req.priority, -st.order, slot, st)
                   for slot, st in enumerate(self.slots)
                   if st is not None and st.pos >= len(st.req.prompt)
                   and st.req.priority < head.priority]
        if not victims:
            return False
        _, _, slot, st = min(victims)
        st.req.preemptions += 1
        self.preemptions += 1
        self._event("preempt", st.req.rid, slot, reason="page pressure")
        self._abort_slot(slot, reason="preempted", requeue_at=1,
                         count_retry=False)
        return True

    def _expire_deadlines(self):
        """Fail the requests past their deadline, queued and in flight."""
        now = self.clock()

        def expired(req):
            return (req.deadline_s is not None
                    and now - req.submit_t > req.deadline_s)

        for req in [r for r in self.queue if expired(r)]:
            self.queue.remove(req)
            self._fail_request(req, "deadline exceeded in queue")
        for slot, st in enumerate(self.slots):
            if st is not None and expired(st.req):
                req = st.req
                self._release_slot(slot, st)
                self._event("abort", req.rid, slot, "deadline",
                            reason="deadline")
                self._fail_request(req, "deadline exceeded")

    def _recover_engine(self):
        """Engine-level recovery after a step failure: rebuild the steps
        and resume from the surviving page tables. The port's steps write
        the cache in place, so this is sound only because the fault sites
        ``serve.prefill`` and ``serve.decode`` fire BEFORE a step grants a
        page or writes a row: a tick that raised left the cache, the tables
        and the pool at their pre-tick state, and retrying it is
        idempotent."""
        self.engine_recoveries += 1
        self._build_steps()
        self._event("recover", reason="engine step failure")

    def _on_fault(self, err: faults_lib.FaultError):
        """Route an injected fault: a ``{"slot": k}`` payload on a live slot
        aborts and retries that request; anything else recovers the
        engine."""
        payload = err.fault.payload if err.fault is not None else {}
        slot = payload.get("slot")
        if slot is not None and self.slots[slot] is not None:
            self._abort_slot(slot, reason=f"injected fault: {err}")
        else:
            self._recover_engine()

    def _shrink(self, survivors):
        """Elastic shrink after a device dropout: abort every live slot back
        to the queue in admission order (no retry charged), drain the
        prefix index, rebind the pool's shares to the surviving classes'
        weights and re-derive the slots' groups and roles. Queued requests
        whose worst case fits no surviving share fail."""
        survivors = sorted(survivors if survivors is not None
                           else range(len(self.pool.shares) - 1))
        if not survivors:
            raise RuntimeError("device dropout left no survivors")
        live = sorted((st.order, slot) for slot, st in enumerate(self.slots)
                      if st is not None)
        for i, (_, slot) in enumerate(live):
            self._abort_slot(slot, reason="device dropout", requeue_at=i,
                             count_retry=False)
        if self.index is not None:
            self.index.clear(self.pool)
        weights = [self.class_weights[g] for g in survivors]
        self.class_weights = weights
        n_g = len(weights)
        self.pool.reshare(page_shares(weights, self.pool.num_pages - 1)
                          if n_g > 1 else [self.pool.num_pages - 1])
        self.groups = [s * n_g // self.num_slots
                       for s in range(self.num_slots)]
        if self.disagg:
            group_roles = derive_roles(weights)
            self.roles = [group_roles[self.groups[s]]
                          for s in range(self.num_slots)]
        self._event("shrink", tuple(survivors), reason="device dropout")
        for req in [r for r in self.queue
                    if self._need_pages(r) > max(self.pool.shares)]:
            self.queue.remove(req)
            self._fail_request(
                req, f"needs {self._need_pages(req)} pages > largest "
                     f"surviving share {max(self.pool.shares)}")

    def assert_page_invariants(self):
        """Structural audit: on top of the pool's own books, every live
        page's refcount equals its holders (slot table entries + prefix
        trie nodes), and every group's reserved balance equals its live
        slots' unconsumed reservations."""
        self.pool.assert_consistent()
        holders: dict = {}
        for st in self.slots:
            if st is None:
                continue
            for p in st.pages:
                if p != 0:
                    holders[p] = holders.get(p, 0) + 1
        if self.index is not None:
            for p in self.index.pages():
                holders[p] = holders.get(p, 0) + 1
        refs = {p: self.pool.refcount(p)
                for p in range(1, self.pool.num_pages)
                if self.pool.refcount(p) > 0}
        if refs != holders:
            raise AssertionError(f"refcount/holder mismatch (leak or "
                                 f"dangler): {refs} vs {holders}")
        per_group = [0] * len(self.pool.shares)
        for st in self.slots:
            if st is not None:
                per_group[st.group] += st.reserved - st.allocated
        for g, want in enumerate(per_group):
            if self.pool._reserved[g] != want:
                raise AssertionError((g, self.pool._reserved[g], want))

    def _index_prompt(self, st: _PagedSlot):
        """Insert the request's FULL prompt pages into the prefix index at
        prefill completion. A window-reclaimed slot skips it: its leading
        pages are gone."""
        if self.index is None or st.reclaimed > 0:
            return
        full = len(st.req.prompt) // self.page_size
        if full > 0:
            self.index.insert(st.req.prompt, st.pages[:full], self.pool)

    def _prefill_tick(self, done: list) -> bool:
        """One chunk of the FIFO-oldest prefilling request on a
        prefill-capable slot. At the prompt's end its first token is drawn
        with the finiteness of its logits in one copy; non-finite logits
        abort and retry the request."""
        cand = [(st.order, slot, st) for slot, st in enumerate(self.slots)
                if st is not None and st.pos < len(st.req.prompt)
                and self.roles[slot] != "decode"]
        if not cand:
            return False
        faults_lib.inject("serve.prefill")
        _, slot, st = min(cand)
        n = min(self.prefill_chunk, len(st.req.prompt) - st.pos)
        self._ensure_pages(slot, st, st.length + n)
        toks = np.zeros((self.prefill_chunk,), np.int32)
        toks[:n] = st.req.prompt[st.pos: st.pos + n]
        with obs.tracer.span("serve.prefill_chunk", rid=st.req.rid,
                             slot=slot, n=n):
            last, self.cache = self._unpack_step(self.prefill_step(
                self.params, self._tensor(toks), n, slot,
                self._tensor(self.table[slot]), self.cache))
        st.pos += n
        st.length += n
        self._reclaim(slot, st)
        self._event("prefill_chunk", st.req.rid, slot, n)
        if st.pos == len(st.req.prompt):
            self._index_prompt(st)
            rows = last.reshape(1, -1)
            for f in faults_lib.inject("serve.prefill_logits"):
                if f.kind == "nan":
                    rows = torch.full_like(rows, float("nan"))
            tok, finite = draw_rows(rows, [st.req], mesh=self.mesh)
            if not finite[0]:
                self._abort_slot(slot, reason="non-finite prefill logits")
                return True
            st.req.out.append(int(tok[0]))
            # one clock read for the dict and the trace instant, so the
            # TTFT derived from the trace is this value, bit for bit
            now = time.perf_counter()
            self.ttft_s[st.req.rid] = now - self._run_t0
            obs.tracer.instant("serve.first_token", t=now, rid=st.req.rid)
            if len(st.req.out) >= st.req.max_new:
                self._finish(slot, st, done)
        return True

    def _handoff(self, src: int, dst: int):
        if self._handoff_step is None:
            self._handoff_step = steps_lib.make_paged_handoff_step(
                self.cfg, self.pcfg, mesh=self.mesh, num_slots=self.num_slots)
        with obs.tracer.span("serve.handoff", src=src, dst=dst):
            self.cache = self._handoff_step(self.cache, src, dst)

    def _transfer_tick(self) -> bool:
        """Disaggregated handoff: move every prefill-role slot that has
        finished its prompt into a free decode-capable slot. The pages stay
        put: the table row and the length move."""
        if not self.disagg:
            return False
        ready = sorted(
            (st.order, src, st) for src, st in enumerate(self.slots)
            if st is not None and self.roles[src] == "prefill"
            and st.pos >= len(st.req.prompt))
        moved = False
        for _, src, st in ready:
            dst = next((s for s in sorted(self.free)
                        if self.roles[s] != "prefill"), None)
            if dst is None:
                break
            self.free.remove(dst)
            self._handoff(src, dst)
            self.table[dst, :] = self.table[src]
            self.table[src, :] = 0
            self.slots[dst] = st
            self.slots[src] = None
            self.free.append(src)
            self.transfers += 1
            self._event("transfer", st.req.rid, src, dst)
            moved = True
        return moved

    def _decode_tick(self, done: list) -> bool:
        """One decode macro-step over every decode-capable slot past
        prefill (with a ``spec`` attached, one speculative verify round a
        slot). The tokens and each row's finiteness reach the host in one
        copy; a non-finite row aborts and retries its request only."""
        if self.spec is not None:
            return self.spec.decode_tick(done)
        dec = [(slot, st) for slot, st in enumerate(self.slots)
               if st is not None and st.pos >= len(st.req.prompt)
               and self.roles[slot] != "prefill"]
        if not dec:
            return False
        faults_lib.inject("serve.decode")
        tokens = np.zeros((self.num_slots, 1), np.int32)
        active = np.zeros((self.num_slots,), bool)
        for slot, st in dec:
            self._ensure_pages(slot, st, st.length + 1)
            tokens[slot, 0] = st.req.out[-1]
            active[slot] = True
        t0 = time.perf_counter()
        with obs.tracer.span("serve.decode", t0=t0, slots=len(dec)):
            logits, self.cache = self._unpack_step(self.serve_step(
                self.params,
                {"tokens": self._tensor(tokens),
                 "page_table": self._tensor(self.table),
                 "active": self._tensor(active)},
                self.cache))
            rows = logits[:, -1]
            for f in faults_lib.inject("serve.logits"):
                if f.kind == "nan":
                    rows[int(f.payload.get("slot", dec[0][0]))] = \
                        float("nan")
            emit = [None] * self.num_slots
            for slot, st in dec:
                emit[slot] = st.req
            nxt, finite = draw_rows(rows, emit, mesh=self.mesh)
        dt = time.perf_counter() - t0
        self.decode_times_s.append(dt)
        obs.registry.histogram(
            "repro_serve_decode_step_seconds",
            "paged decode macro-step latency").observe(dt)
        self._event("decode", tuple(slot for slot, _ in dec))
        for slot, st in dec:
            if not finite[slot]:
                self._abort_slot(slot, reason="non-finite decode logits")
                continue
            st.length += 1
            st.req.out.append(int(nxt[slot]))
            obs.tracer.instant("serve.token", rid=st.req.rid)
            self._reclaim(slot, st)
            if len(st.req.out) >= st.req.max_new:
                self._finish(slot, st, done)
        return True

    def run(self, max_steps: int = 100000) -> list[Request]:
        """Drive admission and ticks until every request has finished or
        failed. Injected faults go through ``_on_fault`` and ``_shrink``;
        failed requests land in ``failed``, never in the return value."""
        done: list[Request] = []
        steps = 0
        self._run_t0 = time.perf_counter()
        # the span starts at _run_t0, so the TTFT derived from the trace
        # subtracts the stamp ttft_s subtracts
        with obs.tracer.span("serve.run", t0=self._run_t0):
            while (self.queue or any(s is not None for s in self.slots)) \
                    and steps < max_steps:
                try:
                    self._expire_deadlines()
                    self._admit()
                    advanced = self._transfer_tick()
                    advanced |= self._prefill_tick(done)
                    advanced |= self._decode_tick(done)
                except faults_lib.DeviceLostError as e:
                    self._shrink(e.survivors)
                    advanced = True
                except faults_lib.FaultError as e:
                    self._on_fault(e)
                    advanced = True
                if self.audit:
                    self.assert_page_invariants()
                if not advanced and not self.queue:
                    break
                steps += 1
                if self.obs_dump_every and steps % self.obs_dump_every == 0:
                    self._dump_metrics()
        self._dump_metrics()
        return done

    def drop_prefix_cache(self) -> int:
        """Release every evictable page the prefix index holds (the leak
        check's drain; an operator's cache flush)."""
        if self.index is None:
            return 0
        return self.index.clear(self.pool)

    def stats(self) -> dict:
        out = {**self.pool.stats(), "admissions": self.admissions,
               "transfers": self.transfers, "aborts": self.aborts,
               "preemptions": self.preemptions,
               "engine_recoveries": self.engine_recoveries,
               "failed": len(self.failed)}
        if self.index is not None:
            out["prefix"] = self.index.stats()
        return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _write_obs(args, server) -> None:
    """The CLI's exit dumps: the Prometheus snapshot (the drain flushed
    first), the Chrome trace with its span coverage and the TTFT/TPOT it
    gives, and the event log."""
    if args.metrics:
        if getattr(server, "router_drain", None) is not None:
            server.router_drain.flush()
        obs.registry.collect()
        obs.dump_prometheus(obs.registry, args.metrics)
        print(f"[serve] metrics -> {args.metrics}")
    if args.trace_out:
        obs.tracer.write(args.trace_out)
        cov = obs.span_coverage(obs.tracer.events)
        ttft, tpot = obs.derive_request_latencies(obs.tracer.events)
        print(f"[serve] trace -> {args.trace_out} "
              f"({len(obs.tracer.events)} events, "
              f"{cov:.0%} span coverage)")
        if ttft:
            ms = sorted(v * 1e3 for v in ttft.values())
            line = (f"[serve] TTFT from spans: median "
                    f"{ms[len(ms) // 2]:.1f}ms over {len(ms)} requests")
            if tpot:
                tp = sorted(v * 1e3 for v in tpot.values())
                line += f"; TPOT median {tp[len(tp) // 2]:.2f}ms"
            print(line)
    if args.events_out:
        obs.events.write_jsonl(args.events_out)
        print(f"[serve] events -> {args.events_out} "
              f"({len(obs.events.records)} records)")


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _unquantized_bytes(params: dict, dtype: torch.dtype) -> int:
    """The bytes ``params`` would take with its 8-bit expert payloads in
    ``dtype`` and no scales: the full-precision tree's."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    total = _tree_bytes(params)
    for layer in params["layers"]:
        for name, t in layer.get("ffn", {}).items():
            if name.endswith("_scale"):
                payload = layer["ffn"][name[:-len("_scale")]]
                total += payload.numel() * (itemsize - 1) - \
                    t.numel() * t.element_size()
    return total

def main(argv=None):
    """CLI entry point: continuous batching of random prompts through a
    seeded random-weight model, on the dense engine or (``--paged``) the
    paged one; ``--mesh`` runs either over the job's ranks
    (``launch.mesh.cli_process_group``), rank 0 printing."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: all)")
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged KV pool (default: the dense "
                         "(slots, max_seq) cache of BatchedServer)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=0,
                    help="shared pool size incl. the sink page "
                         "(0 -> slots * ceil(max_seq/page)/2 + 1)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "fp8"],
                    help="serve block-wise int8/fp8 expert weights through "
                         "the kernels' 8-bit branches")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="store paged-KV pages as int8 rows + per-row "
                         "scales (--paged only)")
    ap.add_argument("--spec-ngram", action="store_true",
                    help="speculative decoding with self-speculative "
                         "n-gram drafting from each request's own token "
                         "history, no draft model (--paged only)")
    ap.add_argument("--spec-draft", default=None, metavar="ARCH",
                    help="speculative decoding with a draft model drawn "
                         "from --seed + 1, resolved with the same --smoke "
                         "switch as --arch (--paged only): an "
                         "all-attention, non-windowed config "
                         "(qwen3-moe-30b-a3b, gemma-2b)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft length per verify round: up to k drafted "
                         "tokens + 1 correction commit per forward")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share full prompt pages across requests through "
                         "a copy-on-write radix index: repeated prefixes "
                         "admit at refcount + 1 and prefill only their "
                         "uncached rest (--paged only)")
    ap.add_argument("--disagg", action="store_true",
                    help="split the slots into prefill and decode roles, "
                         "half and half; finished prefills hand off by "
                         "page-table transfer, no KV copy (--paged only)")
    ap.add_argument("--fault-spec", default=None,
                    help="fault plan, inline JSON or a JSON file ({'seed': "
                         "0, 'faults': [{'site', 'kind', ...}]}, "
                         "runtime.faults): deterministic injection into the "
                         "paged engine's ticks (--paged only)")
    ap.add_argument("--audit", action="store_true",
                    help="check the page books (refcounts == slot holders + "
                         "prefix-trie nodes) after every scheduler step "
                         "(--paged only)")
    ap.add_argument("--mesh", default=None,
                    help="e.g. '2,2' => data,model: the engine on a mesh "
                         "(torchrun or one rank)")
    ap.add_argument("--mode", default="auto",
                    choices=["hybrid", "model_centric", "data_centric",
                             "auto", "ep"],
                    help="parallel mode on a mesh; 'auto' (default) lets "
                         "each MoE layer pick data-/model-centric dispatch "
                         "from the roofline")
    ap.add_argument("--cache-layers", type=int, default=0,
                    help="pipeline-shared prefetch cache residency bound "
                         "(gathered MoE layers) for the serving forwards")
    ap.add_argument("--topology", default=None,
                    help="intra_bw:inter_bw:node_size: a two-level "
                         "interconnect; prices the auto chooser per level "
                         "and, on a mesh whose model extent spans several "
                         "nodes, serves with the hierarchical dispatch "
                         "schedule")
    ap.add_argument("--overlap-dispatch", action="store_true",
                    help="prefetch the next data-centric MoE layer's whole "
                         "expert weights before the current one computes "
                         "(--mode auto). Requires --cache-layers > 0")
    ap.add_argument("--hetero-latencies", default=None,
                    help="comma-separated t_i per batch-group member: an "
                         "Eq. 1 plan, uneven SLOT shares for the dense "
                         "server, uneven PAGE-POOL shares for --paged. "
                         "Requires --mesh for dense")
    ap.add_argument("--hetero-tp-latencies", default=None,
                    help="comma-separated t_i per TP-group member: Eq. 2 "
                         "uneven hidden tiles")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="enable the metrics registry and dump a "
                         "Prometheus text snapshot to PATH at exit; with "
                         "--paged and an MoE config the steps also carry "
                         "per-expert router telemetry")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    metavar="N",
                    help="also dump the Prometheus snapshot every N "
                         "scheduler steps (0 = exit-only)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record spans/instants and write a Chrome "
                         "trace-event JSON (Perfetto-loadable) to PATH")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="write the structured scheduler event log "
                         "(JSONL, monotonic timestamps + reasons) to PATH")
    args = ap.parse_args(argv)
    if args.quant != "none" and args.mesh:
        ap.error("--quant serves whole-expert int8/fp8 payloads; combined "
                 "with --mesh it is not supported (the scales do not shard "
                 "with the experts)")
    if args.cache_layers < 0:
        ap.error("--cache-layers must be >= 0")
    if args.overlap_dispatch and args.cache_layers <= 0:
        ap.error("--overlap-dispatch requires --cache-layers > 0 (the "
                 "prefetcher lives in the pipeline-shared cache)")
    topo = train_lib.parse_topology(ap, args.topology)
    if args.hetero_latencies and not args.mesh and not args.paged:
        ap.error("--hetero-latencies requires --mesh (dense server)")
    mesh_dims = None
    if args.mesh:
        try:
            mesh_dims = mesh_lib.parse_mesh(args.mesh, topo)
        except ValueError as e:
            ap.error(str(e))
    if (args.spec_ngram or args.spec_draft) and not args.paged:
        ap.error("--spec-ngram/--spec-draft require --paged")
    if args.spec_ngram and args.spec_draft:
        ap.error("--spec-ngram and --spec-draft are mutually exclusive")
    if args.kv_quant != "none" and not args.paged:
        ap.error("--kv-quant requires --paged")
    if (args.prefix_cache or args.disagg) and not args.paged:
        ap.error("--prefix-cache/--disagg require --paged")
    if (args.fault_spec or args.audit) and not args.paged:
        ap.error("--fault-spec/--audit require --paged (the recovery "
                 "machinery lives in the paged engine)")
    device = resolve_device(args.device)
    with contextlib.ExitStack() as stack:
        mesh = None
        if mesh_dims is not None:
            dims, axes = mesh_dims
            device = stack.enter_context(mesh_lib.cli_process_group(
                device, int(np.prod(dims))))
            mesh = mesh_lib.make_mesh(dims, axes, device_type=device.type)
        return _serve(ap, args, device, mesh, topo)


def _serve(ap, args, device, mesh, topo):
    say = print if mesh_lib.is_rank0() else (lambda *a, **k: None)
    if args.fault_spec:
        faults_lib.install(faults_lib.load_plan(args.fault_spec))
    # the recorders run on rank 0 only: every rank computes the same
    # global stats and schedule
    obs_on = bool(args.metrics or args.trace_out or args.events_out) \
        and mesh_lib.is_rank0()
    if obs_on:
        obs.configure(metrics=bool(args.metrics),
                      tracing=bool(args.trace_out),
                      event_log=bool(args.events_out), reset=True)
    cfg = (cfglib.get_smoke_config(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    lm.check_servable(cfg)
    plan = None
    num_slots, valid_slots = args.slots, None
    if args.hetero_latencies:
        tp_lat = (None if not args.hetero_tp_latencies else
                  train_lib.parse_latencies(ap, args.hetero_tp_latencies,
                                       "--hetero-tp-latencies"))
        plan = hetero_lib.make_hetero_plan(
            train_lib.parse_latencies(ap, args.hetero_latencies,
                                 "--hetero-latencies"),
            global_batch=args.slots,
            hidden_size=(cfg.moe.d_ff if tp_lat is not None
                         and cfg.moe is not None else None),
            tp_latencies=tp_lat)
        if args.paged:
            say(f"[serve] hetero plan: page-pool shares proportional to "
                f"{plan.token_counts} (all {num_slots} slots schedulable)")
        else:
            # padded slot layout, device i's Eq. 1 share schedulable
            cap = plan.batch_capacity
            num_slots = len(plan.token_counts) * cap
            valid_slots = [i * cap + j
                           for i, c in enumerate(plan.token_counts)
                           for j in range(c)]
            say(f"[serve] hetero plan: slot shares {plan.token_counts} "
                f"({num_slots} padded slots), hidden {plan.hidden_splits}")
    # --metrics adds the router telemetry to the paged engine's steps (the
    # dense engine keeps its 2-tuple steps, as the JAX CLI's does)
    pcfg = ParallelConfig(blk=16, mode=args.mode,
                          cache_layers=args.cache_layers, hetero_plan=plan,
                          topology=topo,
                          overlap_dispatch=args.overlap_dispatch,
                          collect_router_stats=(bool(args.metrics)
                                                and args.paged
                                                and cfg.moe is not None))
    lm.check_mesh(cfg, pcfg, mesh)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if mesh is not None:
        params, _ = steps_lib.sharded_params(cfg, pcfg, mesh, generator=gen,
                                             device=device)
    elif args.quant != "none":
        # quantized layer by layer as drawn: the full-precision tree (61 GB
        # at qwen3-moe-30b-a3b's width) never sits beside its int8 copy
        params = lm.init_params(cfg, generator=gen, device=device,
                                quant=args.quant, plan=plan)
        before = _unquantized_bytes(params, torch_dtype(cfg.dtype))
        say(f"[serve] expert weights -> {args.quant}: params "
            f"{before / 1e6:.1f}MB -> {_tree_bytes(params) / 1e6:.1f}MB")
    else:
        params = lm.init_params(cfg, generator=gen, device=device, plan=plan)
    if args.paged:
        pages = args.pages or (
            args.slots * cdiv(args.max_seq, args.page_size) // 2 + 1)
        server = PagedServer(
            cfg, pcfg, num_slots=args.slots, page_size=args.page_size,
            num_pages=pages,
            max_pages_per_slot=cdiv(args.max_seq, args.page_size),
            params=params, prefill_chunk=args.prefill_chunk, plan=plan,
            kv_quant=args.kv_quant, prefix_cache=args.prefix_cache,
            disagg=args.disagg, audit=args.audit, device=device, mesh=mesh)
        if args.metrics and obs_on:
            server.obs_dump_path = args.metrics
            server.obs_dump_every = args.metrics_interval
        if args.spec_ngram or args.spec_draft:
            # spec imports this module (the shared sampling convention),
            # so it is imported here, never at module level
            from repro_torch.launch import spec as spec_lib
            if args.spec_draft:
                dcfg = (cfglib.get_smoke_config(args.spec_draft)
                        if args.smoke else cfglib.get_config(args.spec_draft))
                dparams = lm.init_params(
                    dcfg, device=device, generator=torch.Generator(
                        device=device).manual_seed(args.seed + 1))
                drafter = spec_lib.ModelDrafter(dcfg, pcfg, dparams,
                                                max_seq=args.max_seq,
                                                device=device)
            else:
                drafter = spec_lib.NGramDrafter()
            spec_lib.SpecDecoder(server, drafter, k=args.spec_k)
    else:
        server = BatchedServer(cfg, pcfg, num_slots=num_slots,
                               max_seq=args.max_seq, params=params,
                               valid_slots=valid_slots, device=device,
                               mesh=mesh)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        server.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=8).astype(np.int32),
            max_new=args.max_new))
    t0 = time.time()
    try:
        done = server.run()
    finally:
        faults_lib.install(None)
    dt = time.time() - t0
    total_tokens = sum(len(r.out) for r in done)
    say(f"[serve] {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / max(dt, 1e-9):.1f} tok/s)")
    if server.decode_times_s:
        ts = np.asarray(server.decode_times_s[1:] or server.decode_times_s)
        say(f"[serve] measured decode step: median "
              f"{np.median(ts) * 1e3:.1f}ms p90 "
              f"{np.percentile(ts, 90) * 1e3:.1f}ms over {len(ts)} steps")
    if args.paged:
        st = server.stats()
        server.drop_prefix_cache()
        per_rank = ("" if mesh is None else
                    f"; {server.kv_bytes() / 1024:.1f} KiB of cache a rank")
        say(f"[serve] page pool: {st['peak_in_use_pages']} peak pages "
              f"({st['peak_in_use_bytes'] / 1024:.1f} KiB KV resident, "
              f"{server.page_bytes} B a {server.kv_quant or cfg.dtype} page"
              f"{per_rank}) "
              f"of {st['num_pages'] - 1} allocatable; {st['total_allocs']} "
              f"allocs, leak-free="
              f"{server.pool.free_pages == st['num_pages'] - 1}")
        if st["aborts"] or st["preemptions"] or st["engine_recoveries"] \
                or st["failed"]:
            say(f"[serve] recovery: {st['aborts']} aborts, "
                  f"{st['preemptions']} preemptions, "
                  f"{st['engine_recoveries']} engine recoveries, "
                  f"{st['failed']} failed")
        if "prefix" in st:
            pf = st["prefix"]
            hit = pf["hit_tokens"] / max(pf["lookup_tokens"], 1)
            say(f"[serve] prefix cache: {hit:.0%} token hit-rate over "
                  f"{pf['lookups']} lookups, {pf['cached_pages']} pages "
                  f"held at the end, {pf['evictions']} LRU evictions")
        if args.disagg:
            say(f"[serve] disagg: roles {server.roles}, "
                  f"{server.transfers} page-table handoffs")
        if server.spec is not None:
            sp = server.spec.stats()
            say(f"[serve] speculative: {sp['rounds']} verify rounds, "
                  f"{sp['accepted_drafts']}/{sp['drafted']} drafts "
                  f"accepted ({sp['acceptance_rate']:.0%}), "
                  f"{sp['rollback_tokens']} rows rolled back")
    else:
        say(f"[serve] dense KV cache: {server.kv_bytes() / 1024:.1f} KiB "
            f"{'a rank ' if mesh is not None else ''}({num_slots} slots, "
            f"max_seq {args.max_seq})")
    if lm.LAST_PIPELINE_CACHE_STATS is not None and args.cache_layers:
        st = lm.LAST_PIPELINE_CACHE_STATS
        say(f"[serve] prefetch cache (last forward): "
            f"{st['peak_resident_layers']} peak resident layers, "
            f"{st['peak_resident_bytes'] / 1024:.1f} KiB, {st['hits']} hits, "
            f"{st['prefetches']} prefetches")
    if obs_on:
        _write_obs(args, server)
    for r in done[:3]:
        say(f"  req {r.rid}: {r.out[:8]}...")
    return done


if __name__ == "__main__":
    main()
